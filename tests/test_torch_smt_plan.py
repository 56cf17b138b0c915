"""The launch plan and the precision scheme of the port's SMT-encode kernel
(``csrc/smt_encode.cu``), on the CPU:

- ``smt_plan`` gives grids that cover every row, column, query, key and head
  at the re-evaluation and rollout batches, and every launch fits an H100
  block; its constants and workspace are the kernel source's;
- a numpy emulation of the kernel's TF32 rounding (``cvt.rna.tf32.f32``) and
  of its 3xTF32 product (hi/lo split, three TF32 products accumulated in
  f32) carries the whole encode within 1e-4 of ``smt_encode_plain`` at the
  rollout shape, the tolerance the kernel is held to on the card; plain
  1xTF32 is reported beside it.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avlen_tpu_torch.ops import smt_cuda
from avlen_tpu_torch.ops.smt_cuda import KERNEL_WEIGHTS, smt_encode_plain, smt_plan

torch.set_num_threads(1)

SRC = (Path(smt_cuda.__file__).resolve().parents[1] / "csrc" / "smt_encode.cu").read_text()
H100_SMEM = 232448
D = 256
CASES = [(b, l, dh) for b in (1, 5, 16, 120) for l in (38, 151, 301) for dh in (16, 32, 64)]


def _c_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


@pytest.mark.parametrize("b,l,dh", CASES)
def test_plan_covers_the_encode_and_fits_an_h100_block(b, l, dh):
    h = D // dh
    m = b * l
    plan = smt_plan(b, l, 288, D, h)
    names = [x.name for x in plan.launches]
    assert names == ["fusion", "qkv", "self_attention", "out_ln", "ffn_ln_kv", "decoder"]
    bm = plan.rows_tile
    assert bm in (16, 32, 64)
    for x in plan.launches:
        assert 0 < x.smem_bytes <= H100_SMEM, x
        assert x.threads % 32 == 0 and x.threads <= 1024, x
        assert x.grid[0] % x.cluster == 0 and x.cluster in (1, 8), x
    fusion, qkv, attn, out_ln, ffn, dec = plan.launches
    for x in (fusion, out_ln, ffn):  # row blocks: every row once, D columns by D/32 warps
        assert x.grid[0] == math.ceil(m / bm) and x.grid[1:] == (1, 1)
        assert x.threads == D * (1 if bm == 64 else 2)  # two K groups below BM = 64
    assert qkv.grid == (math.ceil(m / bm), 3, 1) and qkv.threads == D
    # attention: every query tile, head and batch row; 4 warps of 16 queries
    assert attn.grid == (math.ceil(l / 64), h, b) and attn.threads == 4 * 32
    assert attn.grid[0] * 64 >= l > (attn.grid[0] - 1) * 64
    # decoder: a cluster of 8 CTAs per batch row, D/8 outputs each, heads c, c+8, ...
    assert dec.grid == (8 * b, 1, 1) and dec.cluster == 8 and D % (8 * 4) == 0
    assert math.ceil(h / 8) * 8 >= h
    # the rows tile: the largest whose blocks reach half of the 132 SMs
    bigger = [t for t in (32, 64) if t > bm]
    assert all(math.ceil(m / t) < 66 for t in bigger)
    assert bm == 16 or math.ceil(m / bm) >= 66


@pytest.mark.parametrize("b,l", [(1, 38), (16, 151), (120, 151), (3, 301)])
def test_workspace_is_the_kernel_sources(b, l):
    """The wrapper allocates what the C entry's smt_encode_workspace_floats
    returns (its formula, read from the source) and what the buffers need:
    h, q, k, v and the attention context (B*L x D each; x1 and the
    cross-attention K/V reuse q, k, v) and encoder row L-1 of each batch row."""
    expr = re.search(r"smt_encode_workspace_floats\(int B, int L, int D\) \{\s*return ([^;]+);", SRC).group(1)
    c_value = eval(expr.replace("5LL", "5").replace("(long long)", ""), {"B": b, "L": l, "D": D})
    plan = smt_plan(b, l, 288, D, 8)
    assert plan.workspace_floats == c_value == 5 * b * l * D + b * D
    assert plan.workspace_floats < 6 * b * l * D + 7 * b * D  # the SIMT design's


def test_plan_constants_are_the_kernel_sources():
    assert _c_int("kSMs") == smt_cuda.SMS
    assert _c_int("kMaxSmem") == smt_cuda.MAX_SMEM == H100_SMEM
    assert _c_int("kBK") + 4 == smt_cuda.PAD_K and smt_cuda.PAD_K % 32 == 4
    assert _c_int("kStagesRows") == smt_cuda.STAGES_ROWS
    assert _c_int("kStagesProj") == smt_cuda.STAGES_PROJ
    assert _c_int("kQTile") == smt_cuda.Q_TILE and _c_int("kKTile") == smt_cuda.K_TILE
    assert _c_int("kAttnThreads") == smt_cuda.ATTN_THREADS
    assert _c_int("kTailThreads") == smt_cuda.TAIL_THREADS
    assert _c_int("kTailCluster") == smt_cuda.TAIL_CLUSTER
    assert _c_int("kNumLaunches") == len(smt_plan(16, 151, 288, D, 8).launches)
    kernels = set(re.findall(r"__global__ void __launch_bounds__\(.*?\) (smt_\w+)\(", SRC))
    assert kernels == {x.kernel for x in smt_plan(16, 151, 288, D, 8).launches}
    assert re.search(r"return (\d+);\s*\}", SRC[SRC.index("smt_encode_num_weights"):]).group(1) == str(len(KERNEL_WEIGHTS))


@pytest.mark.parametrize("b,l,f,d,h", [(16, 151, 288, 48, 4), (16, 151, 288, 512, 8), (16, 151, 288, 256, 2),
                                       (16, 151, 288, 256, 3), (2, 100000, 288, 256, 32), (0, 151, 288, 256, 8)])
def test_plan_rejects_what_the_kernel_does_not_take(b, l, f, d, h):
    with pytest.raises(ValueError):
        smt_plan(b, l, f, d, h)


# ---------------------------------------------------------------------------
# precision: numpy emulation of the kernel's TF32 arithmetic
# ---------------------------------------------------------------------------


def tf32_rna(x):
    """cvt.rna.tf32.f32 (and the kernel's cvt_tf32): round the f32 mantissa
    to 10 bits, to nearest, ties away from zero; low 13 bits zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_3xtf32(a, b):
    """a @ b as the kernel's tensor-core products compute it: each operand
    split into hi = tf32(x) and lo = tf32(x - hi); lo*hi + hi*lo + hi*hi,
    each TF32 product exact and accumulated in f32."""
    a, b = a.numpy(), b.numpy()
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return torch.from_numpy(((al @ bh) + (ah @ bl)) + (ah @ bh))


def mm_1xtf32(a, b):
    return torch.from_numpy(tf32_rna(a.numpy()) @ tf32_rna(b.numpy()))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    r = tf32_rna(x)
    assert (r.view(np.uint32) & 0x1FFF == 0).all()
    np.testing.assert_array_less(np.abs(r.astype(np.float64) - x), np.abs(x) * 2.0**-11 + 1e-45)
    # exact ties (bit 12 set, bits 0-11 clear) go away from zero
    tie = np.array([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11], np.float32)
    np.testing.assert_array_equal(tf32_rna(tie), np.array([1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0 + 2.0**-9],
                                                          np.float32))


def _encode(p, entries, valid, goal, nhead, mm):
    """smt_encode_plain's arithmetic with every product that the kernel runs
    on the tensor cores (fusion, QKV, QK^T, PV, out-projection, FFN, cross
    K/V) taken through ``mm``; the decoder's one-row products stay f32, as
    in the kernel's decoder launch."""
    def dense(name, x):
        w, bias = p[f"{name}.weight"], p[f"{name}.bias"]
        return mm(x.reshape(-1, x.shape[-1]), w.t().contiguous()).reshape(*x.shape[:-1], -1) + bias

    def ln(name, x):
        return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps=smt_cuda.LN_EPS)

    b, l, _ = entries.shape
    d = p["fusion0.weight"].shape[0]
    dh = d // nhead
    madd = torch.where(valid != 0, 0.0, smt_cuda.NEG_INF).to(torch.float32)
    h = dense("fusion1", torch.relu(dense("fusion0", entries)))
    a = "enc0.MultiHeadAttention_0"
    q, k, v = (dense(f"{a}.{n}", h).view(b, l, nhead, dh).permute(0, 2, 1, 3) for n in "qkv")
    logits = torch.stack([torch.stack([mm(q[i, j], k[i, j].t().contiguous()) for j in range(nhead)])
                          for i in range(b)]) / math.sqrt(dh) + madd[:, None, None, :]
    attn = torch.softmax(logits, dim=-1)
    ctx = torch.stack([torch.stack([mm(attn[i, j], v[i, j]) for j in range(nhead)]) for i in range(b)])
    x1 = ln("enc0.LayerNorm_0", h + dense(f"{a}.out", ctx.permute(0, 2, 1, 3).reshape(b, l, d)))
    mem = ln("enc0.LayerNorm_1", x1 + dense("enc0.Dense_1", torch.relu(dense("enc0.Dense_0", x1))))
    kc, vc = dense("dec0.cross_attn.k", mem), dense("dec0.cross_attn.v", mem)
    # the decoder: f32 products, the plain version's own code
    tgt = goal[:, None, :] if goal is not None else mem[:, -1:, :]
    sa = F.linear(F.linear(tgt, p["dec0.self_attn.v.weight"], p["dec0.self_attn.v.bias"]),
                  p["dec0.self_attn.out.weight"], p["dec0.self_attn.out.bias"])
    t1 = ln("dec0.LayerNorm_0", tgt + sa)
    qd = F.linear(t1, p["dec0.cross_attn.q.weight"], p["dec0.cross_attn.q.bias"]).view(b, 1, nhead, dh)
    lg = torch.einsum("bqhd,bkhd->bhqk", qd, kc.view(b, l, nhead, dh)) / math.sqrt(dh) + madd[:, None, None, :]
    ca = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(lg, -1), vc.view(b, l, nhead, dh)).reshape(b, 1, d)
    t2 = ln("dec0.LayerNorm_1", t1 + F.linear(ca, p["dec0.cross_attn.out.weight"], p["dec0.cross_attn.out.bias"]))
    f = F.linear(torch.relu(F.linear(t2, p["dec0.Dense_0.weight"], p["dec0.Dense_0.bias"])),
                 p["dec0.Dense_1.weight"], p["dec0.Dense_1.bias"])
    return ln("dec0.LayerNorm_2", t2 + f)[:, 0, :]


def test_3xtf32_encode_holds_the_kernel_tolerance_at_the_rollout_shape(record_property):
    """The rollout shape (B=16, L=151, F=288, D=256, 8 heads), weights from the
    port's SMTStateEncoder: the 3xTF32 encode within 1e-4 of the plain f32
    version (the card's tolerance); 1xTF32 reported, not asserted."""
    from avlen_tpu_torch.models.smt import SMTStateEncoder

    rng = np.random.RandomState(0)
    b, m, feat, nhead = 16, 150, 276, 8
    enc = SMTStateEncoder(feat, D, nhead, pose_indices=(feat - 4, feat), generator=torch.Generator().manual_seed(7))
    x = torch.from_numpy(rng.randn(b, feat).astype(np.float32))
    mem = torch.from_numpy(rng.randn(b, m, feat).astype(np.float32))
    mask = torch.from_numpy((rng.rand(b, m) > 0.3).astype(np.float32))
    goal = torch.from_numpy(rng.randn(b, D).astype(np.float32))
    with torch.no_grad():
        entries, valid = enc.entries(x, mem, mask)
        p = dict(enc.named_parameters())
        want = smt_encode_plain(p, entries, valid, goal, nhead)
        plain_f32 = _encode(p, entries, valid, goal, nhead, torch.matmul)
        err_f32 = (plain_f32 - want).abs().max().item()
        err3 = (_encode(p, entries, valid, goal, nhead, mm_3xtf32) - want).abs().max().item()
        err1 = (_encode(p, entries, valid, goal, nhead, mm_1xtf32) - want).abs().max().item()
    record_property("max_abs_err_3xtf32", err3)
    record_property("max_abs_err_1xtf32", err1)
    print(f"\nmax abs error vs smt_encode_plain: f32 emulation {err_f32:.3g}, "
          f"3xTF32 {err3:.3g}, 1xTF32 {err1:.3g}")
    assert err_f32 <= 1e-5  # the emulation's own structure is the plain version's
    assert err3 <= 1e-4
