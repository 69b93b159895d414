"""conv7_s8_roofline.busy: conv7_s8_roofline in a cell whose end-to-end time is
gpu_busy_ms, which it moves there."""

from posebench.core import registry

read = registry.split_reader(__file__).read
