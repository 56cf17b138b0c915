"""``SPEAKER.BANK_MODE cached`` in the port, on a copy of the reference
fixture tree (tests/data/reference_tree) and on a tiny synthetic world
packed with ``PACK_HOST_RIRS``: where the JAX package's builder gives the
env its host RIR prefetcher (RIRs served from the host store and
TPU.HOST_PREFETCH on) the source is the host speaker, whose tokens equal
the ``callback`` source's and the JAX package's host speaker's for the same
queries (JAX's prefetch cache serves exactly these:
tests/test_chunked_interactive_r5.py); everywhere else it raises JAX's
RuntimeError."""

import numpy as np
import pytest
import torch

from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.dialog import instruction_source as jsource
from avlen_tpu.sim import builder as jbuilder
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.dialog import instruction_source
from avlen_tpu_torch.sim import builder
from tests.test_torch_reference_env import EXTRA, SAVI, copy_fixture, reference_opts

torch.set_num_threads(1)

SPEAKER = ["SPEAKER.BACKEND", "template"]
HOST = ["TASK_CONFIG.SIMULATOR.AUDIO.DENSE_RIR_MAX_BYTES", "0",
        "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False"]
DENSE = ["TASK_CONFIG.SIMULATOR.AUDIO.DENSE_RIR_MAX_BYTES", "2147483648"]
PACKED = [  # a synthetic world of 4 x 4 nodes, its RIRs packed into the host store
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4", "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "8",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "200", "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "2000",
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False", "NUM_PROCESSES", "2",
    "TASK_CONFIG.DATASET.SYNTHETIC.PACK_HOST_RIRS", "True",
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return copy_fixture(tmp_path_factory.mktemp("tree"))


def _env(cfg):
    return builder.construct_batched_env(cfg, with_depth=True, with_rgb=True, extra_sensors=EXTRA, device="cpu")


def _queries(tables, n=48, seed=0):
    rng = np.random.RandomState(seed)
    scene = rng.randint(0, len(tables), n)
    nodes = np.array([t.num_nodes for t in tables])[scene]
    return (scene, rng.randint(0, 1 << 30, n) % nodes, rng.randint(0, 4, n), rng.randint(0, 1 << 30, n) % nodes,
            np.ones(n, bool))


@pytest.mark.parametrize("world", ["reference_tree", "packed_synthetic"])
def test_cached_serves_the_host_speakers_tokens(world, tree):
    opts = reference_opts(tree, HOST) if world == "reference_tree" else list(PACKED)
    cfg = get_config(SAVI, opts=opts + SPEAKER + ["TPU.HOST_PREFETCH", "on", "SPEAKER.BANK_MODE", "cached"])
    env = _env(cfg)
    assert instruction_source.has_host_prefetcher(cfg, env)
    bank, cached = instruction_source.resolve_instruction_source(cfg, env.scene_tables, device="cpu",
                                                                 allow_cached=True)
    assert bank is None and isinstance(cached, instruction_source.HostSpeakerInstructionSource)
    cfg_cb = get_config(SAVI, opts=opts + SPEAKER + ["SPEAKER.BANK_MODE", "callback"])
    _, callback = instruction_source.resolve_instruction_source(cfg_cb, env.scene_tables, device="cpu")
    queries = _queries(env.scene_tables)
    got = cached.host_tokens(*queries)
    np.testing.assert_array_equal(got, callback.host_tokens(*queries))
    assert (np.abs(got).sum(axis=1) > 0).all()

    # the JAX package's host speaker on its own build of the same world
    jopts = reference_opts(tree, DENSE) if world == "reference_tree" else list(PACKED[:-2])
    jcfg = jax_get_config(SAVI, opts=jopts + SPEAKER)
    jtables = jbuilder.construct_batched_env(jcfg, with_depth=True, extra_sensors=EXTRA).scene_tables
    jsrc = jsource.HostSpeakerInstructionSource(jsource.speaker_from_config(jcfg, jtables), jtables)
    np.testing.assert_array_equal(got, jsrc._host_tokens(*queries))


@pytest.mark.parametrize("rirs,prefetch", [("dense", "on"), ("host", "auto"), ("host", "off")])
def test_cached_raises_without_a_host_prefetcher(rirs, prefetch, tree):
    """Dense RIRs have no prefetcher in JAX; host RIRs get one only with
    HOST_PREFETCH on, as auto engages it only without host callbacks."""
    cfg = get_config(SAVI, opts=reference_opts(tree, HOST if rirs == "host" else DENSE) + SPEAKER + [
        "TPU.HOST_PREFETCH", prefetch, "SPEAKER.BANK_MODE", "cached"])
    env = _env(cfg)
    allowed = instruction_source.has_host_prefetcher(cfg, env)
    assert not allowed
    with pytest.raises(RuntimeError, match="chunked-rollout prefetch cache"):
        instruction_source.resolve_instruction_source(cfg, env.scene_tables, device="cpu", allow_cached=allowed)
