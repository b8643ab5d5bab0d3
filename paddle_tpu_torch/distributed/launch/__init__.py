"""``paddle.distributed.launch`` of the port: ``python -m
paddle_tpu_torch.distributed.launch [--nproc_per_node N] script ...``
starts one process per card (see ``main.py``)."""
from .main import launch, main
