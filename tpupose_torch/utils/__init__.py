"""Utilities: observability (logging, profiling) and helpers for runs
without pretrained weights (``calibrate``)."""

from tpupose_torch.utils.profiling import StageTimer, annotate, trace
from tpupose_torch.utils.reporting import TrainLogger, dump_run_params
