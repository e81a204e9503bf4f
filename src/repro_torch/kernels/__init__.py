"""Hand-written CUDA kernels of the port, one package per reference kernel.

Each package keeps the reference's three layers: ``ref.py`` (plain PyTorch,
runs anywhere), ``kernel.py`` (the ctypes wrapper of ``csrc/*.cu``, CUDA
tensors only, with a launch counter) and ``ops.py`` (dispatch on the impl
name; a kernel impl on CPU tensors takes the plain version).
"""

import importlib

# Each kernel wrapper's launch counter: name -> (module, attribute).
LAUNCH_COUNTERS = {
    "cell_rank": ("cell_rank.kernel", "launches"),
    "cell_list_force": ("cell_force.kernel", "launches"),
    "cell_window_force": ("cell_force.kernel", "window_launches"),
    "pairwise_force": ("pairwise_force.kernel", "launches"),
    "diffusion3d": ("diffusion3d.kernel", "launches"),
    "flash_attention": ("flash_attention.kernel", "launches_tc"),
    "flash_attention_simt": ("flash_attention.kernel", "launches"),
    "rmsnorm": ("rmsnorm.kernel", "launches"),
}


def _counter(name):
    module, attr = LAUNCH_COUNTERS[name]
    return importlib.import_module(f"{__name__}.{module}"), attr


def read_launches() -> dict:
    """Every launch counter's value, by kernel name."""
    return {name: getattr(*_counter(name)) for name in LAUNCH_COUNTERS}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (by kernel name) to the counters: a CUDA graph's
    launches at each replay (a wrapper counts only when its Python runs,
    which for a captured kernel is at the capture)."""
    for name, n in counts.items():
        if n:
            module, attr = _counter(name)
            setattr(module, attr, getattr(module, attr) + n)
