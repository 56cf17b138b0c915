"""Work of one launch of the SMT encode (``csrc/smt_encode.cu``, six kernels).

Operations as the algorithm needs them at float32, counted once (the kernel
runs each product as three TF32 products; that is its route, not the
work): per row of ``l`` entries of width ``f`` into ``d``, the fusion MLP,
Q/K/V and the output projection, the FFN and the cross-attention's K/V
projections (f·d + 9·d² a row), the self-attention's scores and weighted
sum (2·l²·d), the decoder's single query (6·d² a batch row) and its
cross-attention (2·l·d), two operations a multiply-add. Bytes: the entries,
their validity, the goal and the weights read once, the output written
once. Against the H100's dense TF32 peak: operations bound it.
"""

MODULE = "avlen_tpu_torch.ops.smt_cuda"  # its ``_launch`` is recorded
PATTERNS = ("smt_",)
PEAK = "tf32"
BOUND = "operations"


def shapes(entries, valid, goal, weights, nhead):
    """``work``'s arguments from one call of the module's ``_launch``."""
    return dict(b=entries.shape[0], l=entries.shape[1], f=entries.shape[2], d=weights[0].shape[0],
                goal=goal is not None, weight_elems=sum(w.numel() for w in weights))


def work(b, l, f, d, goal, weight_elems):
    flops = 2 * (b * l * (f * d + 9 * d * d) + 2 * b * l * l * d + 6 * b * d * d + 2 * b * l * d)
    nbytes = 4 * (b * l * f + b * l + (b * d if goal else 0) + b * d + weight_elems)
    return flops, nbytes
