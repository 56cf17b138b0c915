"""The 1-encoder / 1-decoder Scene Memory Transformer encode.

``smt_encode(params, entries, valid, goal, nhead)``: entries (B, L, F) (the
ring memory plus the current step), valid (B, L) with 1 = attendable, goal
(B, D) or None → (B, D). ``params`` maps the names of ``KERNEL_WEIGHTS``
(the PyTorch ``SMTStateEncoder``'s parameter names) to tensors.

Replaces the TPU kernel ``avlen_tpu/ops/pallas_smt.py:smt_encode``
(``_fused_forward`` → ``pallas_call``, body ``_kernel``). On a CUDA tensor
the forward is the hand-written kernel ``csrc/smt_encode.cu`` inside a
``torch.autograd.Function`` whose backward is autograd through the plain
version, as the JAX custom-vjp ``_bwd`` recomputes through
``smt_encode_ref``. On a CPU tensor the plain version runs.

Bound on an H100: operations. At the rollout shape (B=16, L=151, F=288,
D=256, 8 heads) one call is ~3.6 GFLOP of f32: ~54 µs on the CUDA cores at
67 TFLOP/s. The kernel runs its products on the tensor cores in 3xTF32
(each operand split into a TF32 high and low part, three TF32 products
accumulated in f32, about f32 accuracy: plain TF32 would miss the 1e-4
tolerance), three times the work at 495 TFLOP/s: ~22 µs, the least time a
route that holds the tolerance could take. ``smt_plan`` gives its six
launches (fusion MLP; QKV; self-attention; out-projection + LayerNorm; FFN +
LayerNorm + the cross-attention K/V; the decoder, one cluster of 8 CTAs per
batch row) with their grids, threads and shared memory, and the workspace;
the C entry computes the same plan, and the wrapper checks that the two
agree.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from avlen_tpu_torch.utils import cuda_build

NEG_INF = -1e9
LN_EPS = 1e-6

KERNEL_WEIGHTS = (
    "fusion0.weight", "fusion0.bias", "fusion1.weight", "fusion1.bias",
    "enc0.MultiHeadAttention_0.q.weight", "enc0.MultiHeadAttention_0.q.bias",
    "enc0.MultiHeadAttention_0.k.weight", "enc0.MultiHeadAttention_0.k.bias",
    "enc0.MultiHeadAttention_0.v.weight", "enc0.MultiHeadAttention_0.v.bias",
    "enc0.MultiHeadAttention_0.out.weight", "enc0.MultiHeadAttention_0.out.bias",
    "enc0.LayerNorm_0.weight", "enc0.LayerNorm_0.bias",
    "enc0.Dense_0.weight", "enc0.Dense_0.bias", "enc0.Dense_1.weight", "enc0.Dense_1.bias",
    "enc0.LayerNorm_1.weight", "enc0.LayerNorm_1.bias",
    "dec0.self_attn.v.weight", "dec0.self_attn.v.bias",
    "dec0.self_attn.out.weight", "dec0.self_attn.out.bias",
    "dec0.cross_attn.q.weight", "dec0.cross_attn.q.bias",
    "dec0.cross_attn.k.weight", "dec0.cross_attn.k.bias",
    "dec0.cross_attn.v.weight", "dec0.cross_attn.v.bias",
    "dec0.cross_attn.out.weight", "dec0.cross_attn.out.bias",
    "dec0.LayerNorm_0.weight", "dec0.LayerNorm_0.bias",
    "dec0.LayerNorm_1.weight", "dec0.LayerNorm_1.bias",
    "dec0.Dense_0.weight", "dec0.Dense_0.bias", "dec0.Dense_1.weight", "dec0.Dense_1.bias",
    "dec0.LayerNorm_2.weight", "dec0.LayerNorm_2.bias",
)


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, the test oracle and the backward)
# ---------------------------------------------------------------------------


# An optional 16-bit ``dtype`` runs a layer as the JAX package's non-fused
# layers at TPU.PRECISION (``avlen_tpu/models/smt.py``): each projection
# casts its input and weights to it, each LayerNorm computes in float32 and
# returns it. None or float32 is the kernel's float32 mirror, untouched.


def _low(dtype) -> bool:
    return dtype is not None and dtype != torch.float32


def _ln(p, name, x, dtype=None):
    if not _low(dtype):
        return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps=LN_EPS)
    return F.layer_norm(x.float(), x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps=LN_EPS).to(dtype)


def _dense(p, name, x, dtype=None):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if _low(dtype):
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return F.linear(x, w, b)


def mha_plain(p: Mapping[str, torch.Tensor], name: str, nhead: int, q, k, v, key_valid, dtype=None):
    """Masked multi-head attention: q (B, Lq, D), k/v (B, Lk, D), key_valid
    (B, Lk) nonzero = attendable; masked keys add -1e9, never -inf."""
    b, lq, d = q.shape
    dh = d // nhead
    qh = _dense(p, f"{name}.q", q, dtype).view(b, lq, nhead, dh)
    kh = _dense(p, f"{name}.k", k, dtype).view(b, k.shape[1], nhead, dh)
    vh = _dense(p, f"{name}.v", v, dtype).view(b, v.shape[1], nhead, dh)
    scale = math.sqrt(dh)
    if _low(dtype):  # JAX divides by sqrt(d_head) cast to the logits' dtype
        scale = float(torch.tensor(scale, dtype=dtype))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / scale
    logits = logits + torch.where(key_valid[:, None, None, :] != 0, 0.0, NEG_INF).to(logits.dtype)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, lq, nhead * dh)
    return _dense(p, f"{name}.out", out, dtype)


def enc_layer_plain(p, name: str, nhead: int, src, valid, dtype=None):
    a = mha_plain(p, f"{name}.MultiHeadAttention_0", nhead, src, src, src, valid, dtype)
    src = _ln(p, f"{name}.LayerNorm_0", src + a, dtype)
    f = _dense(p, f"{name}.Dense_1", torch.relu(_dense(p, f"{name}.Dense_0", src, dtype)), dtype)
    return _ln(p, f"{name}.LayerNorm_1", src + f, dtype)


def dec_layer_plain(p, name: str, nhead: int, tgt, mem, valid, dtype=None):
    # the single query's self-attention has one key: softmax is exactly 1
    # (in any dtype), so it is out(v(tgt)) and its q/k projections get no
    # gradient
    a = _dense(p, f"{name}.self_attn.out", _dense(p, f"{name}.self_attn.v", tgt, dtype), dtype)
    tgt = _ln(p, f"{name}.LayerNorm_0", tgt + a, dtype)
    a = mha_plain(p, f"{name}.cross_attn", nhead, tgt, mem, mem, valid, dtype)
    tgt = _ln(p, f"{name}.LayerNorm_1", tgt + a, dtype)
    f = _dense(p, f"{name}.Dense_1", torch.relu(_dense(p, f"{name}.Dense_0", tgt, dtype)), dtype)
    return _ln(p, f"{name}.LayerNorm_2", tgt + f, dtype)


def smt_encode_plain(
    p: Mapping[str, torch.Tensor],
    entries: torch.Tensor,
    valid: torch.Tensor,
    goal: Optional[torch.Tensor],
    nhead: int,
    num_encoder_layers: int = 1,
    num_decoder_layers: int = 1,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    h = _dense(p, "fusion1", torch.relu(_dense(p, "fusion0", entries, dtype)), dtype)
    for i in range(num_encoder_layers):
        h = enc_layer_plain(p, f"enc{i}", nhead, h, valid, dtype)
    tgt = goal[:, None, :] if goal is not None else h[:, -1:, :]
    for i in range(num_decoder_layers):
        tgt = dec_layer_plain(p, f"dec{i}", nhead, tgt, h, valid, dtype)
    return tgt[:, 0, :].float()


# ---------------------------------------------------------------------------
# the launch plan (mirror of plan_make in csrc/smt_encode.cu)
# ---------------------------------------------------------------------------

SMS = 132  # an H100 SXM's streaming multiprocessors
MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
PAD_K = 36  # row stride of a staged 32-wide K slice, = 4 (mod 32) floats
STAGES_ROWS = 3  # staged K slices of a row block that keeps BM x D rows
STAGES_PROJ = 2  # of a QKV block (smaller, so two fit an SM)
Q_TILE = 64  # queries of one attention block (4 warps of 16)
K_TILE = 64  # keys of one staged K/V tile
ATTN_THREADS = 128
TAIL_THREADS = 256
TAIL_CLUSTER = 8  # CTAs of one batch row's decoder
HEAD_WIDTHS = (8, 16, 32, 64)


@dataclass(frozen=True)
class SmtLaunch:
    name: str
    kernel: str  # the CUDA function, as the profiler names it
    grid: Tuple[int, int, int]
    threads: int
    smem_bytes: int
    cluster: int = 1  # CTAs of a thread-block cluster along x


@dataclass(frozen=True)
class SmtPlan:
    """The launches of one ``smt_encode`` call, in order, and its workspace.

    ``rows_tile`` (BM) is the row count of a block of the row-block launches
    (fusion, qkv, out_ln, ffn_ln_kv): the largest of 64, 32, 16 whose blocks
    still reach half of the SMs, since a larger BM reuses each staged weight
    slice over more rows and a smaller one makes more blocks."""

    rows_tile: int
    launches: Tuple[SmtLaunch, ...]
    workspace_floats: int


def _rows_smem(bm: int, d: int, resident: bool) -> int:
    """Shared bytes of a row block: the staged K slices of [W: D x PAD_K]
    [A: BM x PAD_K] and, for a block that keeps its BM rows of width D (an
    intermediate, the LayerNorm input), those rows."""
    if not resident:
        return 4 * STAGES_PROJ * (d + bm) * PAD_K
    return 4 * (bm * (d + 4) + STAGES_ROWS * (d + bm) * PAD_K)


@functools.lru_cache(maxsize=256)
def smt_plan(b: int, l: int, f: int, d: int, h: int) -> SmtPlan:
    """The launches for B rows of L entries of width F, D wide, h heads.

    Against an H100's 132 SMs at the rollout shape (B=16, L=151: M = 2416
    rows, BM = 32): fusion, out_ln and ffn_ln_kv are 76 blocks of 512
    threads, one an SM (154 KB of shared memory each); QKV 228 blocks of 256,
    two an SM (83 KB), so one wave; self-attention 384 blocks of 128, three
    an SM, one wave; the decoder 16 clusters of 8 CTAs, 128 CTAs. At the
    re-evaluation rows (B=120: M = 18120, BM = 64) the row blocks are 284 of
    256 threads, ~2.2 waves, QKV 852 and self-attention 2880. Raises
    ValueError for a shape the kernel does not take."""
    if min(b, l, f, h) < 1 or d % h or d % 32 or d > 256 or d // h not in HEAD_WIDTHS:
        raise ValueError(
            f"smt_encode: B={b} L={l} F={f} D={d} heads={h}: the kernel takes D a multiple of 32 "
            f"up to 256 and a head width of {HEAD_WIDTHS}"
        )
    dh = d // h
    m = b * l
    bm = 64 if -(-m // 64) >= SMS // 2 else 32 if -(-m // 32) >= SMS // 2 else 16
    gm = -(-m // bm)
    # D/32 warps; in the blocks that keep their rows, two groups of them
    # split K below BM = 64
    rt = d * (1 if bm == 64 else 2)
    launches = (
        SmtLaunch("fusion", "smt_fusion", (gm, 1, 1), rt, _rows_smem(bm, d, True)),
        SmtLaunch("qkv", "smt_proj", (gm, 3, 1), d, _rows_smem(bm, d, False)),
        SmtLaunch("self_attention", "smt_attn", (-(-l // Q_TILE), h, b), ATTN_THREADS,
                  4 * ((Q_TILE + 4 * K_TILE) * (dh + 4) + 2 * K_TILE)),
        SmtLaunch("out_ln", "smt_out_ln", (gm, 1, 1), rt, _rows_smem(bm, d, True)),
        SmtLaunch("ffn_ln_kv", "smt_ffn_kv", (gm, 1, 1), rt, _rows_smem(bm, d, True)),
        # ten vectors of D, per-thread partials, reductions, the logits of its heads
        SmtLaunch("decoder", "smt_tail", (TAIL_CLUSTER * b, 1, 1), TAIL_THREADS,
                  4 * (10 * d + TAIL_THREADS + 64 + -(-h // TAIL_CLUSTER) * l), TAIL_CLUSTER),
    )
    for x in launches:
        if x.smem_bytes > MAX_SMEM or max(x.grid[1:]) > 65535:
            raise ValueError(f"smt_encode: B={b} L={l} D={d} heads={h}: {x.name} needs "
                             f"{x.smem_bytes} bytes of shared memory, over {MAX_SMEM}")
    # h, q, k, v, ctx (M x D each) and encoder row L-1 of each batch row
    return SmtPlan(bm, launches, 5 * m * d + b * d)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


class _SMTEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, entries, valid, goal, nhead, *weights):
        ctx.nhead = nhead
        ctx.save_for_backward(entries, valid, goal, *weights)
        return _launch(entries, valid, goal, weights, nhead)

    @staticmethod
    def backward(ctx, grad_out):
        entries, valid, goal, *weights = ctx.saved_tensors
        with torch.enable_grad():
            ws = [w.detach().requires_grad_(True) for w in weights]
            e = entries.detach().requires_grad_(True)
            g = goal.detach().requires_grad_(True) if goal is not None else None
            out = smt_encode_plain(dict(zip(KERNEL_WEIGHTS, ws)), e, valid, g, ctx.nhead)
            inputs = [e] + ([g] if g is not None else []) + ws
            grads = torch.autograd.grad(out, inputs, grad_out, allow_unused=True)
        de = grads[0]
        dg = grads[1] if g is not None else None
        dws = grads[2:] if g is not None else grads[1:]
        return (de, None, dg, None, *dws)


def smt_encode(
    params: Mapping[str, torch.Tensor],
    entries: torch.Tensor,
    valid: torch.Tensor,
    goal: Optional[torch.Tensor],
    nhead: int,
) -> torch.Tensor:
    if entries.device.type == "cpu":
        return smt_encode_plain(params, entries, valid, goal, nhead)
    if entries.device.type != "cuda":
        raise ValueError(f"smt_encode: unsupported device {entries.device}")
    weights = [params[name] for name in KERNEL_WEIGHTS]
    return _SMTEncode.apply(entries, valid, goal, nhead, *weights)


smt_encode.launches = 0


@contextlib.contextmanager
def wrapped_passes(forward: Callable, backward: Callable):
    """Within the block the kernel's launch runs as ``forward(launch)`` and
    the backward (the plain recompute) as ``backward(backward)``: timers or
    profiler labels around the two halves of a training step's encode.
    Both are restored on exit."""
    global _launch
    launch, bwd = _launch, _SMTEncode.backward
    _launch, _SMTEncode.backward = forward(launch), staticmethod(backward(bwd))
    try:
        yield
    finally:
        _launch, _SMTEncode.backward = launch, staticmethod(bwd)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned (the kernel's cp.async chunks)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(entries, valid, goal, weights, nhead: int) -> torch.Tensor:
    b, l, f = entries.shape
    d = weights[0].shape[0]
    dev = entries.device
    plan = smt_plan(b, l, f, d, nhead)
    if valid.shape != (b, l) or (goal is not None and goal.shape != (b, d)):
        raise ValueError("smt_encode: valid must be (B, L) and goal (B, D)")
    if weights[0].shape != (d, f):
        raise ValueError(f"smt_encode: fusion0 weight {tuple(weights[0].shape)} != ({d}, {f})")
    tensors = [entries, valid] + ([goal] if goal is not None else []) + list(weights)
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("smt_encode: every input must be float32 on the entries' device")
    entries, valid = entries.contiguous(), valid.contiguous()
    goal = goal.contiguous() if goal is not None else None
    weights = [_aligned(w) for w in weights]
    lib = _lib()
    _check_plan(lib, plan, (b, l, f, d, nhead))
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=dev)
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    rc = lib.smt_encode(
        entries.data_ptr(), valid.data_ptr(), goal.data_ptr() if goal is not None else None,
        ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(), ws.data_ptr(), b, l, f, d, nhead, cuda_build.current_stream(dev),
    )
    cuda_build.check(rc, "smt_encode")
    smt_encode.launches += 1
    return out


_CHECKED_PLANS = set()


def _check_plan(lib, plan: SmtPlan, shape) -> None:
    """Raise unless the C entry's plan for ``shape`` is ``plan`` (once per shape)."""
    if shape in _CHECKED_PLANS:
        return
    b, l, f, d, h = shape
    info = (ctypes.c_longlong * 7)()
    for i, x in enumerate(plan.launches):
        cuda_build.check(lib.smt_encode_launch_info(b, l, f, d, h, i, info), "smt_encode_launch_info")
        got = (tuple(info[:3]), info[3], info[4], info[5], info[6])
        if got != (x.grid, x.threads, x.smem_bytes, x.cluster, plan.rows_tile):
            raise RuntimeError(f"smt_encode: kernel and wrapper disagree on launch {x.name}: {got}")
    if lib.smt_encode_workspace_floats(b, l, d) != plan.workspace_floats:
        raise RuntimeError("smt_encode: kernel and wrapper disagree on the workspace")
    _CHECKED_PLANS.add(shape)


def _lib():
    lib = cuda_build.load("smt_encode")
    if lib.smt_encode.argtypes is None:
        if lib.smt_encode_num_weights() != len(KERNEL_WEIGHTS):
            raise RuntimeError("smt_encode: kernel and wrapper disagree on the weight list")
        if lib.smt_encode_num_launches() != 6:
            raise RuntimeError("smt_encode: kernel and wrapper disagree on the launch count")
        lib.smt_encode_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.smt_encode_workspace_floats.restype = ctypes.c_longlong
        lib.smt_encode_launch_info.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.smt_encode_launch_info.restype = ctypes.c_int
        lib.smt_encode.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        lib.smt_encode.restype = ctypes.c_int
    return lib
