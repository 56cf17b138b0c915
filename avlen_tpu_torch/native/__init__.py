"""Native host libraries of the port (g++ → shared objects, ctypes)."""

from avlen_tpu_torch.native.build import build_native, load_library, native_lib_path

__all__ = ["build_native", "load_library", "native_lib_path"]
