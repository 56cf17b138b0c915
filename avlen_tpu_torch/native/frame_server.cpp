// Memory-mapped frame-cache server (C ABI).
//
// Native replacement for the reference's per-scene pickled frame caches
// (`DummySimulator` + scene_observations pickles loaded whole into each env
// process — soundspaces/simulator.py:62-93, 372-377). A frame bank is one
// binary file:
//
//   header: int32 magic, N (nodes), A (rotations), H, W, C, dtype_size
//   data:   N*A*H*W*C*dtype_size bytes, row-major (node, rot, h, w, c)
//
// The server memory-maps the file once per host (shared across users of the
// mapping) and serves batched gathers with memcpy into a caller buffer —
// zero-copy from page cache, feeding a pinned host buffer for the device.
// Python bindings: avlen_tpu_torch/native/frame_server.py (ctypes).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int32_t kMagic = 0x41564c46;  // 'AVLF'

struct Bank {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  int32_t n = 0, a = 0, h = 0, w = 0, c = 0, dtype_size = 1;
  size_t frame_bytes() const {
    return static_cast<size_t>(h) * w * c * dtype_size;
  }
};

}  // namespace

extern "C" {

// Open a bank file; returns a handle or nullptr.
void* fs_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const int32_t* hdr = static_cast<const int32_t*>(mem);
  if (hdr[0] != kMagic) {
    munmap(mem, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Bank* b = new Bank();
  b->fd = fd;
  b->size = st.st_size;
  b->n = hdr[1];
  b->a = hdr[2];
  b->h = hdr[3];
  b->w = hdr[4];
  b->c = hdr[5];
  b->dtype_size = hdr[6];
  b->data = static_cast<const uint8_t*>(mem) + 7 * sizeof(int32_t);
  return b;
}

void fs_close(void* h) {
  Bank* b = static_cast<Bank*>(h);
  if (b == nullptr) return;
  munmap(const_cast<uint8_t*>(b->data) - 7 * sizeof(int32_t), b->size);
  ::close(b->fd);
  delete b;
}

void fs_shape(void* h, int32_t* out) {  // [N, A, H, W, C, dtype_size]
  Bank* b = static_cast<Bank*>(h);
  out[0] = b->n;
  out[1] = b->a;
  out[2] = b->h;
  out[3] = b->w;
  out[4] = b->c;
  out[5] = b->dtype_size;
}

// Gather frames for (nodes[i], rots[i]) into out (batch * frame_bytes).
void fs_gather(void* h, int32_t batch, const int32_t* nodes,
               const int32_t* rots, uint8_t* out) {
  Bank* b = static_cast<Bank*>(h);
  const size_t fb = b->frame_bytes();
  for (int i = 0; i < batch; ++i) {
    size_t idx = (static_cast<size_t>(nodes[i]) * b->a + rots[i]) * fb;
    std::memcpy(out + static_cast<size_t>(i) * fb, b->data + idx, fb);
  }
}

}  // extern "C"
