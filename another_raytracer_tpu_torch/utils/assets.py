"""Asset resolution (a jax-free copy of ``another_raytracer_tpu.utils.assets``).

The reference bakes absolute asset paths at CMake configure time
(ressources.h.in, CMakeLists.txt:9-10).  Here assets resolve at runtime from
the ``ARTPU_ASSETS`` directory, else None, and every consumer degrades as
the reference does on a missing file (a solid cyan texture for a missing
image, texture.h:91-92).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def asset_root() -> Optional[Path]:
    root = os.environ.get("ARTPU_ASSETS")
    if root and Path(root).is_dir():
        return Path(root)
    return None


def find(relpath: str) -> Optional[Path]:
    """Resolve e.g. 'textures/earthmap.jpg' or 'models/capsule/capsule.obj'
    under the asset root."""
    root = asset_root()
    if root is None:
        return None
    p = root / relpath
    return p if p.exists() else None


def earthmap_path() -> Optional[Path]:
    return find("textures/earthmap.jpg")


def capsule_obj_path() -> Optional[Path]:
    return find("models/capsule/capsule.obj")


def cow_obj_path() -> Optional[Path]:
    return find("models/cow.obj")


def dino_obj_path() -> Optional[Path]:
    return find("models/dino.obj")
