from avlen_tpu_torch.data.reference import (
    HostRIRStore,
    build_reference_scene_bank,
    load_frame_cache,
    load_reference_episodes,
    load_rir_tree,
    load_scene_graph,
    load_sound_dir,
    pack_rir_tree,
)

__all__ = [
    "HostRIRStore",
    "build_reference_scene_bank",
    "load_frame_cache",
    "load_reference_episodes",
    "load_rir_tree",
    "load_scene_graph",
    "load_sound_dir",
    "pack_rir_tree",
]
