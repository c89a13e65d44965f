"""Host-side data path of the port: COCO parsing and registry (``coco``),
resize numerics (``transforms``) and the eval loader (``loader``)."""

from . import coco, transforms
from .loader import (build_test_loader, choose_bucket, collate_batch, map_record,
                     required_size_divisibility)

__all__ = ["coco", "transforms", "build_test_loader", "choose_bucket",
           "collate_batch", "map_record", "required_size_divisibility"]
