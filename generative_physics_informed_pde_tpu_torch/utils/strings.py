"""Path/string helpers (the port's own copy of
``generative_physics_informed_pde_tpu/utils/strings.py``; reference:
utils/strings.py:3-20)."""

from __future__ import annotations


def ensure_file_extension(path: str, extension: str) -> str:
    """Append ``extension`` (with leading dot) unless already present."""
    if not extension.startswith("."):
        extension = "." + extension
    if path.endswith(extension):
        return path
    return path + extension
