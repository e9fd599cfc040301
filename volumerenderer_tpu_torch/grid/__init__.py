from . import dense, ingest, procedural, transforms
from .dense import BRICK, DenseGrid, from_dense, occupied_bbox
from .ingest import (
    from_nanovdb_blob, from_nvdb, from_vdb, load, save_npz, save_nvdb,
    save_vdb,
)
