"""Distance, top-k, L1, re-ranking, fused-bottleneck, triplet and ranking
operators (counterparts of ``ssg_tpu.ops``)."""

from ssg_tpu_torch.ops.bottleneck import bottleneck_ref, fold_bn, fused_bottleneck
from ssg_tpu_torch.ops.bottleneck_stage import fused_bottleneck_stage, stage_ref
from ssg_tpu_torch.ops.distance import pairwise_distance, pairwise_distance_ref
from ssg_tpu_torch.ops.l1 import l1_distance, l1_distance_ref
from ssg_tpu_torch.ops.metrics import evaluate_rank, rank_stats
from ssg_tpu_torch.ops.rerank import re_ranking
from ssg_tpu_torch.ops.topk import exact_max_k, exact_min_k
from ssg_tpu_torch.ops.triplet import batch_hard_triplet_loss

__all__ = ["pairwise_distance", "pairwise_distance_ref", "l1_distance", "l1_distance_ref",
           "re_ranking", "exact_min_k", "exact_max_k", "fold_bn", "bottleneck_ref",
           "fused_bottleneck", "fused_bottleneck_stage", "stage_ref",
           "batch_hard_triplet_loss", "evaluate_rank", "rank_stats"]
