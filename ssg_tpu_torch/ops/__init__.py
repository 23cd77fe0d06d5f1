"""Distance, top-k, L1 and re-ranking operators (counterparts of ``ssg_tpu.ops``)."""

from ssg_tpu_torch.ops.distance import pairwise_distance
from ssg_tpu_torch.ops.l1 import l1_distance, l1_distance_ref
from ssg_tpu_torch.ops.rerank import re_ranking
from ssg_tpu_torch.ops.topk import exact_max_k, exact_min_k

__all__ = ["pairwise_distance", "l1_distance", "l1_distance_ref", "re_ranking",
           "exact_min_k", "exact_max_k"]
