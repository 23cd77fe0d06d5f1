"""Large-N analytics of the port (counterpart of ``ssg_tpu.parallel``).

On one device for now: the streaming k-reciprocal clustering and the
streaming re-ranked evaluator, whose (N, N) state is one fp32 V plus packed
and bf16 copies, so re-ranking runs at the standard test-split sizes. The
stripe primitives they call (``_stripe.py``) are where a multi-GPU version
goes.
"""

from ssg_tpu_torch.parallel.streaming import (streaming_cluster, streaming_cluster_groups,
                                              streaming_rerank_eval)

__all__ = ["streaming_cluster", "streaming_cluster_groups", "streaming_rerank_eval"]
