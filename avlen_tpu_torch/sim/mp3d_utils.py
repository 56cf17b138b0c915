"""Matterport3D `.house` metadata utilities.

The port's own copy of ``avlen_tpu/sim/mp3d_utils.py`` (numpy only).
Capability match for soundspaces/mp3d_utils.py:64-197 (`HouseReader`:
parses the public Matterport3D `.house` text format for object/category/bbox
lookups feeding the SemanticObjectSensor's instance→mpcat40→task-id remap,
soundspaces/tasks/nav.py:570-698) and the 21-class `CATEGORY_INDEX_MAPPING`.

Clean-room parser of the publicly documented format: whitespace-separated
records keyed by a leading letter — ``C`` category records
(index, category_mapping_index, category_mapping_name, mpcat40_index,
mpcat40_name, ...), ``O`` object records (index, region, category, center xyz,
axes, radii), ``R`` regions, ``L`` levels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# the 21 semantic sound categories of the semantic audionav task
# (soundspaces/mp3d_utils.py CATEGORY_INDEX_MAPPING)
CATEGORY_INDEX_MAPPING = {
    "chair": 0,
    "table": 1,
    "picture": 2,
    "cabinet": 3,
    "cushion": 4,
    "sofa": 5,
    "bed": 6,
    "chest_of_drawers": 7,
    "plant": 8,
    "sink": 9,
    "toilet": 10,
    "stool": 11,
    "towel": 12,
    "tv_monitor": 13,
    "shower": 14,
    "bathtub": 15,
    "counter": 16,
    "fireplace": 17,
    "gym_equipment": 18,
    "seating": 19,
    "clothes": 20,
}


@dataclasses.dataclass
class HouseCategory:
    index: int
    mapping_index: int
    mapping_name: str
    mpcat40_index: int
    mpcat40_name: str


@dataclasses.dataclass
class HouseObject:
    index: int
    region_index: int
    category_index: int
    center: np.ndarray  # (3,)
    radii: np.ndarray  # (3,) obb half-extents


class HouseReader:
    def __init__(self, path: str):
        self.categories: Dict[int, HouseCategory] = {}
        self.objects: List[HouseObject] = []
        self.num_levels = 0
        self.num_regions = 0
        with open(path, "r") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                tag = parts[0]
                if tag == "C" and len(parts) >= 6:
                    cat = HouseCategory(
                        index=int(parts[1]),
                        mapping_index=int(parts[2]),
                        mapping_name=parts[3].replace("#", " "),
                        mpcat40_index=int(parts[4]),
                        mpcat40_name=parts[5].replace("#", " "),
                    )
                    self.categories[cat.index] = cat
                elif tag == "O" and len(parts) >= 14:
                    self.objects.append(
                        HouseObject(
                            index=int(parts[1]),
                            region_index=int(parts[2]),
                            category_index=int(parts[3]),
                            center=np.array([float(x) for x in parts[4:7]], np.float32),
                            radii=np.array([float(x) for x in parts[13:16] if x])
                            if len(parts) >= 16
                            else np.zeros(3, np.float32),
                        )
                    )
                elif tag == "L":
                    self.num_levels += 1
                elif tag == "R":
                    self.num_regions += 1

    def compute_object_to_category_index_mapping(self) -> Dict[int, int]:
        """instance id → mpcat40 index (HouseReader usage in
        compute_semantic_index_mapping, soundspaces/simulator.py:425-436)."""
        mapping: Dict[int, int] = {}
        for obj in self.objects:
            cat = self.categories.get(obj.category_index)
            mapping[obj.index] = cat.mpcat40_index if cat else -1
        return mapping

    def object_task_category(self, obj: HouseObject) -> Optional[int]:
        """mpcat40 name → 21-way semantic task id, None if unmapped."""
        cat = self.categories.get(obj.category_index)
        if cat is None:
            return None
        return CATEGORY_INDEX_MAPPING.get(cat.mpcat40_name.replace(" ", "_"))

    def objects_in_category(self, task_category: int) -> List[HouseObject]:
        return [o for o in self.objects if self.object_task_category(o) == task_category]


# mpcat40 index per task category (SemanticObjectSensor's
# category_to_mp3d_category_id, soundspaces/tasks/nav.py:616-637)
CATEGORY_TO_MP3D_CATEGORY_ID = {
    "chair": 3,
    "table": 5,
    "picture": 6,
    "cabinet": 7,
    "cushion": 8,
    "sofa": 10,
    "bed": 11,
    "chest_of_drawers": 13,
    "plant": 14,
    "sink": 15,
    "toilet": 18,
    "stool": 19,
    "towel": 20,
    "tv_monitor": 22,
    "shower": 23,
    "bathtub": 25,
    "counter": 26,
    "fireplace": 27,
    "gym_equipment": 33,
    "seating": 34,
    "clothes": 38,
}

NUM_TASK_CATEGORIES = max(CATEGORY_INDEX_MAPPING.values()) + 1  # 21


def task_id_to_mp3d_id() -> np.ndarray:
    """(21,) task category id → raw mpcat40 index (the MPCAT40Index sensor's
    mapping, soundspaces/tasks/nav.py:520-543)."""
    table = np.zeros((NUM_TASK_CATEGORIES,), np.int32)
    for name, tid in CATEGORY_INDEX_MAPPING.items():
        table[tid] = CATEGORY_TO_MP3D_CATEGORY_ID[name]
    return table


def mp3d_id_to_task_id() -> np.ndarray:
    """(200,) mpcat40 index → 21-way task id; unmapped classes collapse to
    the extra 'unknown' id 21 (SemanticObjectSensor._initialize_category_
    mappings, soundspaces/tasks/nav.py:640-651)."""
    table = np.full((200,), -1, np.int32)
    for name, task_id in CATEGORY_INDEX_MAPPING.items():
        table[CATEGORY_TO_MP3D_CATEGORY_ID[name]] = task_id
    table[table == -1] = NUM_TASK_CATEGORIES
    return table
