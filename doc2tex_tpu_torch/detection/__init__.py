"""Math detection: SSD512 over sliding windows, decode and NMS on the
device, page-level NMS or the voting stitch, and the detector's training
(counterpart of ``doc2tex_tpu.detection``)."""

from .boxes import batched_detect, decode_boxes, nms_fixed
from .flow import MathDetector
from .priors import MATH_GTDB_512, make_priors
from .ssd import SSD512
from .windows import expand_boxes, rolling_windows, unmap_boxes

__all__ = ["MATH_GTDB_512", "make_priors", "SSD512", "decode_boxes", "nms_fixed",
           "batched_detect", "MathDetector", "rolling_windows", "unmap_boxes", "expand_boxes"]
