"""The training step of the port (``paddle.jit.train_step``)."""
from .train_step import TrainStep, train_step

__all__ = ["TrainStep", "train_step"]
