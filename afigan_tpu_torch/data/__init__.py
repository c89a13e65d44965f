"""Host-side data path of the port: COCO parsing and registry (``coco``),
transforms (``transforms``), the training mapper (``dataset_mapper``) and the
eval and train loaders (``loader``)."""

from . import coco, transforms
from .loader import (PrefetchingLoader, TrainingSampler, build_test_loader,
                     build_train_loader, choose_bucket, collate_batch, map_record,
                     required_size_divisibility)

__all__ = ["coco", "transforms", "PrefetchingLoader", "TrainingSampler", "build_test_loader",
           "build_train_loader", "choose_bucket", "collate_batch",
           "map_record", "required_size_divisibility"]
