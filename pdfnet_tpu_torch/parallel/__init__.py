"""Data and tensor parallelism over processes on ``torch.distributed``
(port of ``pdfnet_tpu/parallel``)."""

from pdfnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Zero1Adam,
    gather_to_host,
    make_mesh_2d,
    maybe_initialize_distributed,
    process_local_batch_size,
    shard_params_tp,
    zero1_state_shardings,
)
