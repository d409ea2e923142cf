from .artifacts import (
    ArtifactStore,
    load_displacement,
    load_params,
    load_params_meta,
    save_displacement,
    save_params,
)

__all__ = [
    "ArtifactStore",
    "load_displacement",
    "load_params",
    "load_params_meta",
    "save_displacement",
    "save_params",
]
