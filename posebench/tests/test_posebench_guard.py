"""The loaded-module check compares whole top-level names."""

from posebench.core.guard import forbidden_modules


def test_whole_top_level_names():
    names = ["tpupose_torch", "tpupose_torch.ops.conv7", "numpy",
             "jaxtyping", "flaxen", "tpupose", "tpupose.ops", "jax",
             "jax._src.core", "jaxlib.xla_client", "flax.linen", "optax",
             "orbax.checkpoint"]
    assert forbidden_modules(names) == sorted(
        ["tpupose", "tpupose.ops", "jax", "jax._src.core",
         "jaxlib.xla_client", "flax.linen", "optax", "orbax.checkpoint"])
    assert forbidden_modules(["tpupose_torch", "tpupose_torchx"]) == []


def test_harness_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; import posebench.run, posebench.control; "
            "from posebench.core import registry; "
            "[registry.driver(d) for d in ('pose_live', 'hand_crops')]; "
            "import tpupose_torch.detectors; "
            "from posebench.core.guard import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
