"""Multi-rank scale-out of the port (counterpart of ``ssg_tpu.parallel``).

JAX's single-controller SPMD over a device mesh becomes one process a rank
over a ``torch.distributed`` process group (``mesh.py``):

  * data-parallel extraction and fine-tuning: each rank takes its slice of
    every batch (``dp.py``, ``api.extract_features(mesh=)``,
    ``train.trainer``);
  * the (N, N) analytics row-sharded over the ranks with ring collectives
    (``ring.py``): the dense ``sharded.py`` (distance, eps, DBSCAN) and
    ``rerank.py``, and the streaming clustering and re-ranked evaluation
    (``streaming.py``), which also run on one device.

``multihost.py`` joins the process group (torchrun's environment, or an
explicit coordinator). The CPU tests run gloo ranks; on cards the backend
is NCCL, one rank a device.
"""

from ssg_tpu_torch.parallel.dp import replicate, shard_batch
from ssg_tpu_torch.parallel.mesh import Mesh, make_mesh
from ssg_tpu_torch.parallel.multihost import global_put
from ssg_tpu_torch.parallel.multihost import initialize as initialize_multihost
from ssg_tpu_torch.parallel.rerank import sharded_re_ranking
from ssg_tpu_torch.parallel.sharded import (sharded_dbscan, sharded_pairwise_distance,
                                            sharded_select_eps)
from ssg_tpu_torch.parallel.streaming import (streaming_cluster, streaming_cluster_groups,
                                              streaming_rerank_eval)

__all__ = ["Mesh", "make_mesh", "replicate", "shard_batch", "global_put",
           "initialize_multihost", "sharded_pairwise_distance", "sharded_select_eps",
           "sharded_dbscan", "sharded_re_ranking", "streaming_cluster",
           "streaming_cluster_groups", "streaming_rerank_eval"]
