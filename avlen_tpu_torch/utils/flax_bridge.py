"""Carry the JAX package's parameters and worlds into the PyTorch port.

``load_flax_params(module, params)`` copies a Flax parameter tree, given as
nested dicts of numpy arrays (or anything ``np.asarray`` accepts), into a
port module whose submodule names follow the Flax tree:

* ``Dense`` kernel (in, out) → ``Linear.weight`` (out, in);
* ``DenseGeneral`` kernel (D, H, dh) → (H·dh, D), and (H, dh, D) → (D, H·dh);
* conv kernel HWIO → OIHW;
* LayerNorm/GroupNorm ``scale``/``bias`` → ``weight``/``bias``.

``to_flax_params(module)`` is the inverse: the module's parameters (or any
tensors keyed by its parameter names, such as Adam's moments) as the Flax
tree the JAX package would hold, ``{"params": {...}}`` of numpy arrays. The
checkpoints store that tree, so they interchange with the JAX package.
``adam_to_flax``/``load_adam_flax`` keep a ``torch.optim.Adam``'s state in
trees at the same paths (the port's own optimizer format).

``scene_bank_from_jax(bank, device)`` carries a JAX ``SceneBank`` across:
tables, sounds, frames and the procedural RIR tails (``tail_noise``,
``tail_fft``, ``itd_phase``), which the JAX package draws from
``jax.random`` and PyTorch cannot reproduce.

The module only duck-types the JAX objects it is handed; it imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from avlen_tpu_torch.models.smt import MultiHeadAttention
from avlen_tpu_torch.sim.scene import ProceduralRIRBank, SceneBank


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


_TORCH_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def torch_name(path: Tuple[str, ...]) -> str:
    """The torch parameter name of a Flax leaf path."""
    *mods, leaf = path
    if leaf not in _TORCH_LEAF:
        raise ValueError(f"unexpected Flax leaf {'/'.join(path)}")
    return ".".join(mods + [_TORCH_LEAF[leaf]])


def convert_leaf(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    """(torch parameter name, array in the torch layout) for one Flax leaf."""
    *mods, leaf = path
    name = torch_name(path)
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 3 and mods[-1] == "out":  # (H, dh, D) → (D, H·dh)
            value = value.reshape(-1, value.shape[-1]).T
        elif value.ndim == 3:  # (D, H, dh) → (H·dh, D)
            value = value.reshape(value.shape[0], -1).T
        elif value.ndim == 4:  # HWIO → OIHW
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {value.shape}")
    elif leaf == "bias":
        value = value.reshape(-1)
    return name, np.ascontiguousarray(value)


def torch_arrays(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{torch parameter name: array in the torch layout} of a Flax tree
    (with or without its ``params`` level)."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    if not params:
        return {}
    return dict(convert_leaf(path, value) for path, value in _flatten(params).items())


@torch.no_grad()
def load_flax_params(module: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Copy every Flax leaf into ``module``; every parameter of ``module``
    must be covered, with its exact shape."""
    own = dict(module.named_parameters())
    seen = set()
    for name, arr in torch_arrays(params).items():
        if name not in own:
            raise KeyError(f"no parameter {name!r} for this Flax leaf")
        p = own[name]
        if tuple(p.shape) != arr.shape:
            raise ValueError(f"{name}: torch {tuple(p.shape)} vs Flax {arr.shape}")
        p.copy_(torch.tensor(arr, dtype=p.dtype))
        seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"parameters not in the Flax tree: {missing}")


def _heads(modules: Dict[str, torch.nn.Module], name: str) -> int:
    """The head count of the nearest enclosing module that holds one."""
    while name:
        name = name.rpartition(".")[0]
        nhead = getattr(modules[name], "nhead", None)
        if nhead is not None:
            return int(nhead)
    raise ValueError("an attention projection outside any module with nhead")


def flax_path(modules: Dict[str, torch.nn.Module], name: str) -> Tuple[str, ...]:
    """The Flax leaf path of parameter ``name``; ``modules`` is
    ``dict(named_modules())``. The inverse of ``torch_name``."""
    owner_name, _, leaf = name.rpartition(".")
    owner = modules[owner_name]
    if leaf == "weight":
        leaf = "kernel" if isinstance(owner, (torch.nn.Linear, torch.nn.Conv2d)) else "scale"
    elif leaf != "bias":
        raise ValueError(f"unexpected parameter {name}")
    return tuple(owner_name.split(".")) + (leaf,)


def flax_leaf(modules: Dict[str, torch.nn.Module], name: str, value: np.ndarray) -> Tuple[Tuple[str, ...], np.ndarray]:
    """(Flax path, array in the Flax layout) of the tensor ``value`` in the
    shape of parameter ``name``. The inverse of ``convert_leaf``."""
    owner_name, _, leaf = name.rpartition(".")
    owner = modules[owner_name]
    parent_name, _, attr = owner_name.rpartition(".")
    if isinstance(owner, torch.nn.Linear) and isinstance(modules.get(parent_name), MultiHeadAttention):
        h = _heads(modules, parent_name)
        if leaf == "weight" and attr == "out":  # (D, H·dh) → (H, dh, D)
            value = value.T.reshape(h, -1, value.shape[0])
        elif leaf == "weight":  # (H·dh, D) → (D, H, dh)
            value = value.T.reshape(value.shape[1], h, -1)
        elif attr != "out":  # bias (H·dh,) → (H, dh)
            value = value.reshape(h, -1)
    elif leaf == "weight" and isinstance(owner, torch.nn.Linear):
        value = value.T
    elif leaf == "weight" and isinstance(owner, torch.nn.Conv2d):  # OIHW → HWIO
        value = value.transpose(2, 3, 1, 0)
    return flax_path(modules, name), np.ascontiguousarray(value)


def _nest(items: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    """``{"params": tree}`` of leaves keyed by their paths."""
    tree: Dict[str, Any] = {}
    for path, value in items.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return {"params": tree}


def to_flax_params(module: torch.nn.Module, tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """``{"params": tree}``: the module's parameters, or ``tensors`` keyed
    by parameter names in the parameters' shapes, as the Flax tree of numpy
    arrays the JAX package holds for the same network."""
    modules = dict(module.named_modules())
    if tensors is None:
        tensors = dict(module.named_parameters())
    return _nest(dict(flax_leaf(modules, n, t.detach().cpu().numpy()) for n, t in tensors.items()))


def adam_to_flax(module: torch.nn.Module, adam: torch.optim.Optimizer) -> Dict[str, Any]:
    """The state of a ``torch.optim.Adam`` over ``module``'s parameters as
    Flax trees at the parameters' paths: ``exp_avg`` and ``exp_avg_sq`` in
    the Flax layout, ``step`` as 0-d float32 arrays. Parameters that never
    had a gradient have no state, and no leaf."""
    modules = dict(module.named_modules())
    names = {id(p): n for n, p in module.named_parameters()}
    state = {names[id(p)]: st for p, st in adam.state.items() if st}
    out = {k: to_flax_params(module, {n: st[k] for n, st in state.items()}) for k in ("exp_avg", "exp_avg_sq")}
    out["step"] = _nest({flax_path(modules, n): np.asarray(float(st["step"]), np.float32) for n, st in state.items()})
    return out


@torch.no_grad()
def load_adam_flax(module: torch.nn.Module, adam: torch.optim.Optimizer, state: Mapping[str, Any]) -> None:
    """Replace the Adam state with ``adam_to_flax``'s trees, exactly."""
    own = dict(module.named_parameters())
    steps = {torch_name(path): v for path, v in _flatten(state["step"].get("params", {})).items()}
    avg, avg_sq = torch_arrays(state["exp_avg"]), torch_arrays(state["exp_avg_sq"])
    adam.state.clear()
    for name, step in steps.items():
        p = own[name]
        # torch keeps a non-capturable Adam's step as a float32 CPU scalar
        adam.state[p] = {"step": torch.tensor(float(step), dtype=torch.float32),
                         "exp_avg": torch.tensor(avg[name], dtype=p.dtype, device=p.device),
                         "exp_avg_sq": torch.tensor(avg_sq[name], dtype=p.dtype, device=p.device)}


def scene_bank_from_jax(bank: Any, device: Union[str, torch.device] = "cuda") -> SceneBank:
    """A port SceneBank holding the JAX bank's arrays (RIR tails included)."""

    def t(x):
        return None if x is None else torch.tensor(np.asarray(x), device=device)

    tables = {k: t(v) for k, v in bank.tables.items()}
    r = bank.rir
    rir = ProceduralRIRBank(
        positions=tables["positions"], length=r.length, sampling_rate=r.sampling_rate,
        seed=r.seed, tail_scale=r.tail_scale, tail_tau_s=r.tail_tau_s, num_tails=r.num_tails,
        tail_noise=t(r.tail_noise), tail_fft=t(r.tail_fft), itd_phase=t(r.itd_phase),
    )
    return SceneBank(
        tables=tables,
        sounds_padded=t(bank.sounds_padded),
        sound_secs=t(bank.sound_secs),
        rir=rir,
        rgb=t(bank.rgb),
        depth=t(bank.depth),
        semantic=t(bank.semantic),
        semantic_instance_to_mp3d=t(bank.semantic_instance_to_mp3d),
        grid_size=bank.grid_size,
        sampling_rate=bank.sampling_rate,
        num_categories=bank.num_categories,
        sound_fft_bank=t(bank.sound_fft_bank),
        spec_bank=None if bank.spec_bank is None else t(np.asarray(bank.spec_bank, np.float32)).to(torch.bfloat16),
    )
