from . import dense, procedural, transforms
from .dense import BRICK, DenseGrid, from_dense, occupied_bbox
