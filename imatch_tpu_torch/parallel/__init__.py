"""Multi-device paths and training: the (data, model) device grid, the
Megatron partition specs and their placement, the contrastive training
step over the grid, checkpoints, the row-sharded index engines over a
device list (parallel/mesh.py), GPipe over stacked layers, ring attention
over the sequence, and the grid across processes (parallel/
distributed.py)."""

from imatch_tpu_torch.parallel.distributed import (
    initialize,
    process_count,
    process_index,
    shutdown,
)
from imatch_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from imatch_tpu_torch.parallel.sharding import (
    clip_param_specs,
    data_spec,
    md_param_specs,
    replicated,
)
from imatch_tpu_torch.parallel.dist_ivf import (
    prepare_sharded_ivf,
    prepare_sharded_ivf_incremental,
    sharded_ivf_topk,
)
from imatch_tpu_torch.parallel.dist_search import (
    pad_corpus_for_mesh,
    prepare_sharded_corpus,
    sharded_cosine_topk,
    sharded_topk_prepared,
)
from imatch_tpu_torch.parallel.pipeline import gpipe_scan
from imatch_tpu_torch.parallel.ring_attention import ring_attention
from imatch_tpu_torch.parallel.train import (
    TrainState,
    clip_loss,
    init_train_state,
    make_train_step,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "clip_param_specs",
    "data_spec",
    "md_param_specs",
    "replicated",
    "pad_corpus_for_mesh",
    "prepare_sharded_corpus",
    "prepare_sharded_ivf",
    "prepare_sharded_ivf_incremental",
    "sharded_cosine_topk",
    "sharded_ivf_topk",
    "sharded_topk_prepared",
    "gpipe_scan",
    "ring_attention",
    "initialize",
    "process_count",
    "process_index",
    "shutdown",
    "TrainState",
    "clip_loss",
    "make_train_step",
    "init_train_state",
]
