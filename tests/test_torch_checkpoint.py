"""The port's checkpoints are the JAX package's files: its msgpack encoder
writes flax.serialization's bytes, a checkpoint written by
``avlen_tpu.utils.checkpoint.save_checkpoint`` loads in the port bit-equal
and one written by the port loads in the JAX package bit-equal;
``merge_matching_params`` lists the paths JAX lists; checkpoint folders
sort by index, leave no ``.tmp`` behind, and the preemption state round
trips."""

import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from avlen_tpu.utils import checkpoint as jckpt
from avlen_tpu_torch.utils import checkpoint as tckpt
from avlen_tpu_torch.utils import msgpack_codec

torch.set_num_threads(1)


def _tree(seed=0):
    """A Flax-like parameter tree of several dtypes and ranks."""
    rng = np.random.RandomState(seed)
    return {"params": {
        "net": {"Dense_0": {"kernel": rng.randn(7, 5).astype(np.float32), "bias": rng.randn(5).astype(np.float32)},
                "Conv_0": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32)},
                "attn": {"q": {"kernel": rng.randn(8, 2, 4).astype(np.float32),
                               "bias": rng.randn(2, 4).astype(np.float32)}}},
        "LayerNorm_0": {"scale": np.ones(5, np.float32), "bias": np.zeros(5, np.float32)},
    }}


def _payload():
    return {
        "state_dict": _tree(0),
        "optim_state": {"count": np.asarray(12, np.int32), "mu": _tree(1)["params"]},
        "belief_predictor": _tree(2),
        "config": {"SEED": 3, "VIDEO_OPTION": [], "TASK_CONFIG": {"DATASET": {"HELD_OUT_SOUNDS": [3, 4]}}},
        "extra_state": {"step": 4800},
    }


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) or hasattr(want, "dtype"):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("tree", [
    _tree(0),
    {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129, -2**31 - 1],
     "floats": [0.0, -1.5, 1e300], "flags": [True, False, None], "mixed": [1, "a", [2.5, []]],
     "strs": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70000], "bin": b"\x00\xff" * 200,
     "scalars": {"f": np.float32(2.5), "i": np.int64(-7), "b": np.bool_(True)},
     "arrays": {"zero_d": np.asarray(3, np.int32), "empty": np.zeros((2, 0, 3)), "bool": np.array([True, False]),
                "f16": np.ones(3, np.float16), "c64": np.array([1 + 2j], np.complex64),
                "big": np.arange(70000, dtype=np.uint8)},
     "many": {str(i): i for i in range(20)}, "empty": {}},
])
def test_encoder_writes_flax_bytes(tree):
    want = flax.serialization.msgpack_serialize(tree)
    assert msgpack_codec.packb(tree) == want
    _assert_tree_equal(msgpack_codec.unpackb(want), flax.serialization.msgpack_restore(want))


def test_jax_written_checkpoint_loads_in_the_port_bit_equal(tmp_path):
    payload = _payload()
    path = jckpt.save_checkpoint(str(tmp_path), "ckpt.0.pth", payload)
    got = tckpt.load_checkpoint(path)
    _assert_tree_equal(got, jckpt.load_checkpoint(path))
    _assert_tree_equal(got["state_dict"], payload["state_dict"])
    assert got["config"] == payload["config"] and got["extra_state"] == {"step": 4800}


def test_port_written_checkpoint_loads_in_jax_bit_equal(tmp_path):
    payload = _payload()
    path = tckpt.save_checkpoint(str(tmp_path / "port"), "ckpt.0.pth", payload)
    got = jckpt.load_checkpoint(path)
    _assert_tree_equal(jax.tree.map(np.asarray, got["state_dict"]), payload["state_dict"])
    _assert_tree_equal(jax.tree.map(np.asarray, got["optim_state"]), payload["optim_state"])
    assert got["config"] == payload["config"] and got["extra_state"] == {"step": 4800}
    # the same payload through both packages' save_checkpoint: the same file
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), "ckpt.0.pth", payload)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()


def _policy_tree(d_model: int, pretraining: bool):
    """The port's SAVi policy parameters as a Flax tree (to_flax_params)."""
    from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy
    from avlen_tpu_torch.utils.flax_bridge import to_flax_params

    gen = torch.Generator().manual_seed(0)
    net = AudioNavSMTNet(spectrogram_hw=(65, 26), d_model=d_model, nhead=4, pretraining=pretraining,
                         use_rgb=False, generator=gen)
    return to_flax_params(SMTPolicy(net, generator=gen))


def test_merge_lists_jax_paths_for_stage_transfer():
    """Stage 1 (pretraining) → stage 2 over the same widths copies every
    leaf; over another d_model, and with a subtree missing or added, the
    copied and skipped lists are JAX's, in JAX's order, and the merged
    values the source's where copied and the target's where skipped."""
    stage1, stage2 = _policy_tree(32, True), _policy_tree(32, False)
    other = _policy_tree(64, True)
    del other["params"]["critic"]
    other["params"]["extra_head"] = {"Dense_0": {"bias": np.zeros(3, np.float32)}}
    stage2["params"]["net"]["smt"]["pose_encoder"]["kernel"] = stage2["params"]["net"]["smt"]["pose_encoder"][
        "kernel"].astype(np.float16)  # a target dtype the merge must keep
    for source in (stage1, other):
        merged, copied, skipped = tckpt.merge_matching_params(stage2, source)
        jmerged, jcopied, jskipped = jckpt.merge_matching_params(stage2, source)
        assert copied == jcopied and skipped == jskipped
        _assert_tree_equal(merged, jax.tree.map(np.asarray, jmerged))
    assert len(skipped) > 10 and len(copied) > 10 and "params/critic" in skipped
    _, copied, skipped = tckpt.merge_matching_params(stage2, stage1)
    assert not skipped and len(copied) == len(jax.tree.leaves(stage2))


def test_list_checkpoints_sorts_by_index_and_leaves_no_tmp(tmp_path):
    for i in (10, 2, 9, 0, 1):
        tckpt.save_checkpoint(str(tmp_path), f"ckpt.{i}.pth", {"extra_state": {"step": i}})
    names = [os.path.basename(p) for p in tckpt.list_checkpoints(str(tmp_path))]
    assert names == [f"ckpt.{i}.pth" for i in (0, 1, 2, 9, 10)]
    assert names == [os.path.basename(p) for p in jckpt.list_checkpoints(str(tmp_path))]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert os.path.basename(tckpt.poll_checkpoint_folder(str(tmp_path), 2)) == "ckpt.9.pth"
    assert tckpt.poll_checkpoint_folder(str(tmp_path), 4) is None


def test_preemption_state_roundtrip(tmp_path, monkeypatch):
    from avlen_tpu_torch.utils import preemption

    monkeypatch.setattr(preemption, "INTERRUPTED_STATE_DIR", str(tmp_path))
    assert preemption.load_interrupted_state() is None
    path = preemption.save_interrupted_state({"step": 7, "arr": np.arange(3)})
    state = preemption.load_interrupted_state()
    assert state["step"] == 7
    np.testing.assert_array_equal(state["arr"], np.arange(3))
    assert os.path.exists(path)
