from .coco_eval import CocoEvalNP, CocoEvaluator
from .rle import decode_rle, encode_mask, polygons_to_mask

__all__ = ["CocoEvalNP", "CocoEvaluator", "decode_rle", "encode_mask",
           "polygons_to_mask"]
