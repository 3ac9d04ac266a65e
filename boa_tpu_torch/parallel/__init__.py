"""Multi-device training and inference on `torch.distributed`.

Counterpart of `boa_tpu/parallel/` (the reference's meshes and sharding
rules, which XLA's GSPMD turned into collectives). Here one process runs
per device: `mesh.py` builds the process group and the dp x sp x tp
`DeviceMesh` and states the sharding rules, `spmd.py` keeps a rank's
shards by those rules and writes out the train step's collectives (the step
is `train/trainer.py`'s), `sharded_inference.py` the
sliding window over dp, and `dryrun.py` one flagship train step over N
ranks (`python -m boa_tpu_torch.parallel.dryrun --n N`).
"""

from boa_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
    spatial_sharding,
)
