"""setup_s: process start to the first timed call (imports, inputs and
weights, calibration, the program's build and quantize, warm-up)."""


def read(ctx):
    return ctx.setup_s
