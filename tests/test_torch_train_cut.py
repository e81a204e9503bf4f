"""The depth cuts of ``chip_smoke.py``'s full-width train phases against the
reference on the CPU.

For each (arch, layers) of ``TRAIN_PHASES`` the port's parameter tree, built
on the meta device (no storage, no draws), has the keys, shapes and dtypes
of the reference's ``jax.eval_shape`` of ``init`` at the same cut, and the
cut config's ``layer_kinds()`` are the reference's and the published
pattern's first ``layers``: the cut keeps the published widths and the
reference's layer pattern, and allocates nothing.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.models.params import unzip
from repro_torch import training
from repro_torch.configs import get_config
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
_chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_chip_smoke)
TRAIN_PHASES = _chip_smoke.TRAIN_PHASES

# The fields a cut may not change: every width, the pattern and the
# encoder, patch and expert counts.
WIDTHS = ("family", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
          "n_experts", "top_k", "block_pattern", "activation", "norm", "window",
          "prefix_tokens", "rnn_head_dim", "lru_width", "conv1d_width", "n_encoder_layers",
          "encoder_seq", "tie_embeddings", "dtype", "param_dtype")


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_phases_cover_the_other_nine_archs():
    from repro_torch.configs import ARCHS

    archs = [a for _, a, *_ in TRAIN_PHASES]
    assert sorted(archs) == sorted(set(ARCHS) - {_chip_smoke.LM_ARCH})
    assert len({p for p, *_ in TRAIN_PHASES}) == len(TRAIN_PHASES)


@pytest.mark.parametrize("prefix,arch,layers,batch,length", TRAIN_PHASES,
                         ids=[a for _, a, *_ in TRAIN_PHASES])
def test_cut_keeps_published_widths_and_pattern(prefix, arch, layers, batch, length):
    published = get_config(arch)
    assert 2 <= layers <= published.n_layers and layers % len(published.block_pattern) == 0
    cut = dataclasses.replace(published, n_layers=layers, attention_impl="cuda", remat=True)
    jcut = dataclasses.replace(jax_get_config(arch), n_layers=layers, remat=True)
    for f in WIDTHS:
        assert getattr(cut, f) == getattr(published, f) == getattr(jcut, f), f
    assert cut.layer_kinds() == jcut.layer_kinds() == published.layer_kinds()[:layers]
    if arch.startswith("recurrentgemma"):
        assert "local_attn" in cut.layer_kinds()

    params, _ = training.eval_params(build_model(cut))
    leaves = jax.tree.leaves(params)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    shapes = jax.eval_shape(lambda k: unzip(jax_build_model(jcut).init(k))[0],
                            jax.random.PRNGKey(0))
    assert _flat(params) == _flat(shapes)
