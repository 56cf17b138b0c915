"""TPU.PRECISION in the port's conv towers against the JAX package on the CPU.

Each tower that takes a compute dtype in JAX (ResNet-18, AudioCNN,
VisualCNN, MapCNN, SMTCNN, the belief predictor; the SMT layers, CLIP, the
dialog state encoder and the AV-Nav/AV-WAN nets are in
tests/test_torch_precision_nets.py) is built at a small width from the
port's own init carried into the Flax tree, and run on numpy-seeded inputs
at bfloat16 and float16:

* **dtype chain**: the dtype of every intermediate that Flax's
  ``capture_intermediates`` reports (each Conv, Dense, norm, submodule and
  the output) equals the dtype the port's layer returns at the same path;
* **values**: ``max|port - jax| <= 2*d + 1e-3*peak`` on every output,
  where ``d = max|jax_low - jax_f32|`` and ``peak = max|jax_f32|`` on the
  same inputs, stated before the run.

Also the torch rules that make this needed: ``nn.GroupNorm``/
``nn.LayerNorm`` fed bfloat16 with float32 parameters return bfloat16
(Flax: float32), and ``F.linear``/``F.conv2d`` refuse bfloat16 input with
float32 weights, while the port's layers follow Flax."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avlen_tpu.models.avwan_policy import MapCNN as JaxMapCNN
from avlen_tpu.models.belief_predictor import BeliefPredictorNet as JaxBelief
from avlen_tpu.models.encoders import AudioCNN as JaxAudioCNN
from avlen_tpu.models.encoders import VisualCNN as JaxVisualCNN
from avlen_tpu.models.resnet import ResNet18 as JaxResNet18
from avlen_tpu.models.smt_cnn import SMTCNN as JaxSMTCNN
from avlen_tpu_torch.models import layers
from avlen_tpu_torch.models.avwan_policy import MapCNN
from avlen_tpu_torch.models.belief_predictor import BeliefPredictorNet
from avlen_tpu_torch.models.encoders import AudioCNN, VisualCNN
from avlen_tpu_torch.models.resnet import ResNet18
from avlen_tpu_torch.models.smt_cnn import SMTCNN
from avlen_tpu_torch.ops import smt_cuda
from avlen_tpu_torch.utils.flax_bridge import to_flax_params

torch.set_num_threads(1)

def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(jnp.dtype(str(t.dtype).split(".")[1]))


LOW = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
B, D, H = 3, 32, 4


def compiled(fn, *args):
    """``jax.jit(fn)(*args)``, compiled without LLVM's expensive passes
    (the same numbers in about half the compile time)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})(*args)


def flax_params(tmod, jmod, *args, **kwargs):
    """The port module's parameters as ``{"params": tree}``, held to the
    paths and shapes of the JAX module's init (traced, not run)."""
    params = to_flax_params(tmod)
    want = jax.eval_shape(lambda: jmod.init(jax.random.key(0), *args, **kwargs))
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda a: a.shape, want)
    return params


def jax_dtypes(jmod, params, args, method=None):
    """{Flax module path "a/b": {dtypes of its __call__ outputs}} from
    ``capture_intermediates``, traced only."""
    def run():
        return jmod.apply(params, *args, method=method, capture_intermediates=True, mutable=["intermediates"])[1]

    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                out["/".join(path)] = {np.dtype(a.dtype) for a in jax.tree.leaves(v)}
            else:
                walk(v, path + (k,))

    walk(jax.eval_shape(run)["intermediates"], ())
    return out


@contextlib.contextmanager
def port_dtypes():
    """Records {path: {output dtypes}} of every hooked module's forward and
    of the SMT plain layers' projections and LayerNorms (functions of
    ``ops/smt_cuda.py`` keyed by their parameter prefix)."""
    rec, handles = {}, []
    dense, ln = smt_cuda._dense, smt_cuda._ln

    def hooked(fn):
        def run(p, name, x, dtype=None):
            y = fn(p, name, x, dtype)
            rec.setdefault(name.replace(".", "/"), set()).add(_np_dtype(y))
            return y

        return run

    def watch(module):
        for name, m in module.named_modules():
            def hook(_, __, out, name=name):
                outs = [o for o in (out if isinstance(out, tuple) else (out,)) if isinstance(o, torch.Tensor)]
                rec.setdefault(name.replace(".", "/"), set()).update(_np_dtype(o) for o in outs)

            handles.append(m.register_forward_hook(hook))

    smt_cuda._dense, smt_cuda._ln = hooked(dense), hooked(ln)
    try:
        yield rec, watch
    finally:
        smt_cuda._dense, smt_cuda._ln = dense, ln
        for h in handles:
            h.remove()


LEAF_LAYERS = (torch.nn.Conv2d, torch.nn.Linear, torch.nn.GroupNorm, torch.nn.LayerNorm)


def check_chain(tmod, got, want):
    """Every port layer that ran has a JAX counterpart of the same output
    dtypes; every Conv/Dense/norm of the port that ran is among them."""
    leaves = {n.replace(".", "/") for n, m in tmod.named_modules() if isinstance(m, LEAF_LAYERS)}
    compared = 0
    for path, dts in got.items():
        if path in want:
            assert dts == want[path], f"{path}: port {dts}, jax {want[path]}"
            compared += 1
        else:
            assert path not in leaves, f"{path} has no Flax counterpart"
    assert compared >= 3
    return compared


def check_values(got, low, f32, floor=0.0):
    """max|port - jax_low| <= 2*d + 1e-3*peak (+ ``floor``), output by output."""
    for g, w, r in zip(got, low, f32):
        g = g.detach().float().numpy()
        w, r = np.asarray(w, np.float32), np.asarray(r, np.float32)
        d = np.abs(w - r).max()
        bound = 2 * d + 1e-3 * np.abs(r).max() + floor
        err = np.abs(g - w).max()
        assert np.isfinite(g).all() and err <= bound, f"err {err} > bound {bound} (d {d})"


def _torch_leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in _torch_leaves(o)] if isinstance(out, (tuple, list)) else []


# ---------------------------------------------------------------------------
# the cases: (port module at dtype, JAX module at dtype, inputs, method)
# ---------------------------------------------------------------------------


def _resnet(dt, jdt, rng):
    return (ResNet18(1, 8, width=16, generator=torch.Generator().manual_seed(0), dtype=dt),
            JaxResNet18(num_outputs=8, width=16, dtype=jdt), (rng.rand(4, 32, 32, 1).astype(np.float32),))


def _audio_cnn(dt, jdt, rng):
    return (AudioCNN(32, (65, 26), generator=torch.Generator().manual_seed(0), dtype=dt),
            JaxAudioCNN(32, (65, 26), dtype=jdt), (rng.rand(B, 65, 26, 2).astype(np.float32) * 4,))


def _visual_cnn(dt, jdt, rng):
    return (VisualCNN(32, (16, 16), use_rgb=True, use_depth=True, generator=torch.Generator().manual_seed(0),
                      dtype=dt),
            JaxVisualCNN(32, dtype=jdt),
            (rng.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8), rng.rand(B, 16, 16, 1).astype(np.float32)))


def _map_cnn(dt, jdt, rng):
    return (MapCNN(32, 20, 2, generator=torch.Generator().manual_seed(0), dtype=dt),
            JaxMapCNN(32, dtype=jdt), (rng.rand(B, 20, 20, 2).astype(np.float32),))


def _smt_cnn(dt, jdt, rng):
    return (SMTCNN(generator=torch.Generator().manual_seed(0), dtype=dt), JaxSMTCNN(dtype=jdt),
            (rng.randint(0, 256, (2, 24, 24, 3)).astype(np.uint8), rng.rand(2, 24, 24, 1).astype(np.float32)))


def _belief(dt, jdt, rng):
    return (BeliefPredictorNet(generator=torch.Generator().manual_seed(0), dtype=dt), JaxBelief(dtype=jdt),
            (rng.rand(2, 65, 13, 2).astype(np.float32),))


def _features(tmod, args):
    """The nets' feature towers (the dtype-chain part of AV-Nav/AV-WAN)."""
    return tmod.net.features({k: torch.as_tensor(v) for k, v in args[0].items()})


TOWERS = {  # the conv towers; tests/test_torch_precision_nets.py holds the rest
    "resnet": _resnet, "audio_cnn": _audio_cnn, "visual_cnn": _visual_cnn, "map_cnn": _map_cnn,
    "smt_cnn": _smt_cnn, "belief_predictor": _belief,
}


def _port_call(tmod, args, method):
    def tensor(a):
        return {k: tensor(v) for k, v in a.items()} if isinstance(a, dict) else torch.as_tensor(np.array(a))

    t = [tensor(a) for a in args]
    with torch.no_grad():
        return _features(tmod, args) if method == "features" else tmod(*t)


def _jax_call(jmod, params, args, method):
    if method == "features":
        return compiled(lambda p, o: jmod.apply(p, o, method=lambda m, o: m.net.features(o)), params, args[0])
    return compiled(lambda p, *a: jmod.apply(p, *a), params, *args)


@functools.lru_cache(maxsize=None)
def _reference(build, method):
    """(port module at float32, its Flax tree, inputs, JAX's float32
    outputs), shared by a case's two low precisions."""
    t32, j32, args = build(torch.float32, jnp.float32, np.random.RandomState(0))
    init_args, kw = (args + (jax.random.key(0),), {"method": "act"}) if method == "features" else (args, {})
    params = flax_params(t32, j32, *init_args, **kw)  # the policies' act initialises every submodule
    return t32, params, args, jax.tree.leaves(_jax_call(j32, params, args, method))


def run_case(build, low, method=None):
    """The dtype chain and the values of one module at one low precision;
    ``method`` "features" runs a policy's feature towers."""
    t32, params, args, want_f32 = _reference(build, method)
    dt, jdt = LOW[low]
    tlow, jlow, _ = build(dt, jdt, np.random.RandomState(0))
    tlow.load_state_dict(t32.state_dict())
    with port_dtypes() as (rec, watch):
        watch(tlow)
        got = _port_call(tlow, args, method)
    jfn = (lambda m, o: m.net.features(o)) if method == "features" else None
    want = jax_dtypes(jlow, params, args[:1] if method == "features" else args, method=jfn)
    check_chain(tlow, rec, want)
    if method is None:  # the module's own output dtypes
        assert {_np_dtype(x) for x in _torch_leaves(got)} == want[""]
    check_values(_torch_leaves(got), jax.tree.leaves(_jax_call(jlow, params, args, method)), want_f32)


@pytest.mark.parametrize("low", list(LOW))
@pytest.mark.parametrize("case", list(TOWERS))
def test_module_dtype_chain_and_values_match_jax(case, low):
    run_case(TOWERS[case], low)


# ---------------------------------------------------------------------------
# torch's own mixed-dtype rules, and the port's layers against them
# ---------------------------------------------------------------------------


def _mixed(kind):
    x = torch.randn(2, 16, 4, 4).bfloat16()
    if kind == "torch_group_norm":
        return torch.nn.GroupNorm(4, 16)(x).dtype == torch.bfloat16
    if kind == "torch_layer_norm":
        return torch.nn.LayerNorm(4)(x).dtype == torch.bfloat16
    if kind == "torch_linear":
        with pytest.raises(RuntimeError):
            F.linear(x, torch.randn(3, 4))
        return True
    if kind == "torch_conv2d":
        with pytest.raises(RuntimeError):
            F.conv2d(x, torch.randn(8, 16, 3, 3))
        return True
    if kind == "port_group_norm":  # Flax's GroupNorm without a dtype: float32
        y = layers.GroupNorm(4, 16)(x)
        want = F.group_norm(x.float(), 4, eps=1e-5)
        return y.dtype == torch.float32 and torch.allclose(y, want, atol=1e-6)
    if kind == "port_layer_norm":
        return layers.LayerNorm(4)(x).dtype == torch.float32 and layers.LayerNorm(4, dtype=torch.bfloat16)(
            x.float()).dtype == torch.bfloat16
    if kind == "port_linear":  # no dtype: promoted to float32; at bf16: bf16
        return layers.Linear(4, 3)(x).dtype == torch.float32 and layers.Linear(
            4, 3, dtype=torch.bfloat16)(x.float()).dtype == torch.bfloat16
    if kind == "port_conv2d":
        return layers.Conv2d(16, 8, 3, dtype=torch.bfloat16)(x.float()).dtype == torch.bfloat16 and layers.Conv2d(
            16, 8, 3)(x).dtype == torch.float32
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["torch_group_norm", "torch_layer_norm", "torch_linear", "torch_conv2d",
                                  "port_group_norm", "port_layer_norm", "port_linear", "port_conv2d"])
def test_mixed_dtype_rules(kind):
    assert _mixed(kind)


@pytest.mark.parametrize("name,want", [("bfloat16", torch.bfloat16), ("BF16", torch.bfloat16),
                                       ("fp32", torch.float32), ("float16", torch.float16), ("int8", ValueError)])
def test_precision_table_is_jax_table(name, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="unknown TPU.PRECISION"):
            layers.precision_dtype(name)
    else:
        assert layers.precision_dtype(name) == want


def test_float32_layers_are_torch_layers_bit_for_bit():
    """At float32 the port's layers run torch's own calls: equal to
    nn.Conv2d/nn.Linear/nn.GroupNorm/nn.LayerNorm with the same weights."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 6, 6, generator=g)
    for mine, theirs, inp in (
        (layers.Conv2d(16, 8, 3, 2, 1, dtype=torch.float32), torch.nn.Conv2d(16, 8, 3, 2, 1), x),
        (layers.Linear(6, 5), torch.nn.Linear(6, 5), x),
        (layers.GroupNorm(4, 16, eps=1e-6), torch.nn.GroupNorm(4, 16, eps=1e-6), x),
        (layers.LayerNorm(6, eps=1e-6), torch.nn.LayerNorm(6, eps=1e-6), x),
    ):
        theirs.load_state_dict(mine.state_dict())
        with torch.no_grad():
            for p in mine.parameters():
                p.normal_(generator=g)
            theirs.load_state_dict(mine.state_dict())
            assert torch.equal(mine(inp), theirs(inp))
