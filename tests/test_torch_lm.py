"""The port's LM serving path against the reference ``Model`` on the CPU.

Reduced configs (2 layers, or 2 pattern groups; d 64, head_dim 16, f32);
weights drawn by the reference and carried across with
``convert.lm_params_from_numpy``; the reference runs its Pallas attention
kernel in interpret mode (``attention_impl="pallas"``) or its O(T²) oracle,
the port ``"cuda"`` (its plain version on CPU tensors).  Every config of
``configs/archs.py`` builds; the VLM batch carries ``patches``, the
encoder–decoder's ``frames``.  Tolerances: f32 logits ``atol=5e-5``
(products and softmax sums in other orders over d = 64 and two layers;
seen: 5.2e-6 of logits up to 5.4); bf16 logits relative L2 ≤ 2e-2 (the two
frameworks round the bf16 residual stream at other places; seen: 6e-3);
greedy tokens exact.  ``tests/test_torch_lm_families.py`` holds the new
families' prefill and decode, ``test_torch_moe.py`` and
``test_torch_recurrent.py`` their blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np

from repro import training as jax_training
from repro.configs import reduced_config as jax_reduced_config
from repro.models.model import build_model as jax_build_model
from repro.models.params import unzip
from repro_torch import convert, training
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.models.model import build_model

ATOL = 5e-5
PORTED = sorted(ARCHS)
# The reference's attention in Pallas interpret mode where its mask varies
# (prefix, window); the O(T²) oracle elsewhere, which is faster.
PALLAS = ("phi4-mini-3.8b", "paligemma-3b", "recurrentgemma-9b")


def _pair(arch="phi4-mini-3.8b", dtype="float32", jax_impl="pallas", port_impl="cuda",
          **overrides):
    """(jax model, jax params, port model, port params) from one draw; both
    reduced configs take the same ``overrides``."""
    cj = dataclasses.replace(jax_reduced_config(arch, **overrides), attention_impl=jax_impl,
                             dtype=dtype)
    ct = dataclasses.replace(reduced_config(arch, **overrides), attention_impl=port_impl,
                             dtype=dtype)
    mj, mt = jax_build_model(cj), build_model(ct)
    pj = unzip(mj.init(jax.random.PRNGKey(0)))[0]
    pt = convert.lm_params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")
    return mj, pj, mt, pt


def _tokens(b, t, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def lm_batch(cfg, b, t, seed=0):
    """A numpy batch: ``tokens``, and ``patches`` (VLM) or ``frames``
    (encoder–decoder) of unit normals."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(0, 1, (b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(0, 1, (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax(arch):
    impl = "pallas" if arch in PALLAS else "reference"
    mj, pj, mt, pt = _pair(arch, jax_impl=impl, port_impl="cuda")
    batch = lm_batch(mj.cfg, 2, 24)
    want, aux_want = mj.forward(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = mt.forward(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 24, mj.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-6)
    assert (float(aux) > 0) == mj.cfg.is_moe


def test_forward_bf16_matches_jax():
    mj, pj, mt, pt = _pair(dtype="bfloat16")
    toks = _tokens(2, 24, mj.cfg.vocab_size, seed=1)
    want = to_np(mj.forward(pj, {"tokens": jnp.asarray(toks)})[0])
    got = mt.forward(pt, {"tokens": torch.from_numpy(toks)})[0].numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


def test_prefill_step_matches_jax():
    mj, pj, mt, pt = _pair()
    toks = _tokens(3, 40, mj.cfg.vocab_size, seed=2)
    want = jax.jit(jax_training.make_prefill_step(mj))(pj, {"tokens": jnp.asarray(toks)})
    counts = (fa_kernel.launches, rms_kernel.launches)
    got = training.make_prefill_step(mt)(pt, {"tokens": torch.from_numpy(toks)})
    assert (fa_kernel.launches, rms_kernel.launches) == counts   # CPU: plain versions
    assert tuple(got.shape) == (3, 1, mj.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), to_np(want), atol=ATOL, rtol=0)


def test_decode_steps_match_jax():
    """Eight greedy decode steps from one prompt token, the cache written
    in place on the port's side: logits within ATOL, tokens equal."""
    mj, pj, mt, pt = _pair()
    b = 2
    cj, ct = mj.init_cache(b, 16), mt.init_cache(b, 16, "cpu")
    step_j = jax.jit(mj.decode_step)
    step_t = training.make_decode_step(mt)
    first = _tokens(b, 1, mj.cfg.vocab_size, seed=3)
    tj, tt = jnp.asarray(first), torch.from_numpy(first)
    for i in range(8):
        lj, cj = step_j(pj, cj, tj, jnp.int32(i))
        lt, ct = step_t(pt, ct, tt, i)
        np.testing.assert_allclose(lt.numpy(), to_np(lj), atol=ATOL, rtol=0, err_msg=f"step {i}")
        tj = jnp.argmax(lj[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], dim=-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), to_np(tj), err_msg=f"step {i}")
    np.testing.assert_allclose(ct["layers"]["b0"]["kv"]["k"].numpy(),
                               to_np(cj["layers"]["b0"]["kv"]["k"]), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_agrees_with_prefill(dtype):
    """The port's two serving paths on one prompt: the last position's
    logits of the token-by-token decode against the prefill step (the
    flash path).  f32 within ATOL; bf16 relative L2 ≤ 2e-2."""
    _, _, mt, pt = _pair(dtype=dtype)
    toks = torch.from_numpy(_tokens(2, 12, mt.cfg.vocab_size, seed=4))
    pre = training.make_prefill_step(mt)(pt, {"tokens": toks})
    cache = mt.init_cache(2, 12, "cpu")
    step = training.make_decode_step(mt)
    for i in range(12):
        dec, cache = step(pt, cache, toks[:, i:i + 1], i)
    if dtype == "float32":
        np.testing.assert_allclose(dec.numpy(), pre.numpy(), atol=ATOL, rtol=0)
    else:
        assert float(torch.linalg.norm(dec - pre) / torch.linalg.norm(pre)) <= 2e-2


def _layer_cases():
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, (32, 48)).astype(np.float32)
    mlp = {k: rng.normal(0, 0.2, s).astype(np.float32)
           for k, s in (("wi_up", (32, 48)), ("wi_gate", (32, 48)), ("wo", (48, 32)))}
    table = rng.normal(0, 0.2, (40, 32)).astype(np.float32)
    heads = rng.normal(0, 1, (2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None] + 5
    t = torch.from_numpy
    j = jnp.asarray
    tm = lambda d: {k: t(v) for k, v in d.items()}
    jm = lambda d: {k: j(v) for k, v in d.items()}
    return {
        "linear": (lambda: jl.linear_apply({"w": j(w)}, j(x), jnp.float32),
                   lambda: tl.linear_apply({"w": t(w)}, t(x), torch.float32)),
        "swiglu": (lambda: jl.glu_mlp_apply(jm(mlp), j(x), "swiglu", jnp.float32),
                   lambda: tl.glu_mlp_apply(tm(mlp), t(x), "swiglu", torch.float32)),
        "geglu": (lambda: jl.glu_mlp_apply(jm(mlp), j(x), "geglu", jnp.float32),
                  lambda: tl.glu_mlp_apply(tm(mlp), t(x), "geglu", torch.float32)),
        "gelu_two_matrix": (
            lambda: jl.glu_mlp_apply(jm({k: mlp[k] for k in ("wi_up", "wo")}), j(x), "gelu",
                                     jnp.float32),
            lambda: tl.glu_mlp_apply(tm({k: mlp[k] for k in ("wi_up", "wo")}), t(x), "gelu",
                                     torch.float32)),
        "rope": (lambda: jl.rope(j(heads), j(pos), 10000.0),
                 lambda: tl.rope(t(heads), t(pos), 10000.0)),
        "embed": (lambda: jl.embed_apply({"table": j(table)}, j(pos + 20), jnp.float32),
                  lambda: tl.embed_apply({"table": t(table)}, t(pos + 20), torch.float32)),
        "tied_logits": (lambda: jl.tied_logits_apply({"table": j(table)}, j(x), jnp.float32),
                        lambda: tl.tied_logits_apply({"table": t(table)}, t(x), torch.float32)),
    }


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_layers_match_jax(name):
    """Each ported layer on one f32 input against the reference's; RoPE's
    pow / cos / sin may differ from XLA's by ulps (atol 1e-5 at positions
    up to 11)."""
    want, got = _layer_cases()[name]
    np.testing.assert_allclose(got().numpy(), to_np(want()), atol=1e-5, rtol=1e-5)


def test_init_tree_matches_reference_structure():
    """Same keys, shapes and dtypes as the reference's value tree; the
    reference's std rule (fan-in = first axis, also for wo (H, Dh, D))."""
    cj = jax_reduced_config("phi4-mini-3.8b")
    shapes = jax.eval_shape(lambda k: unzip(jax_build_model(cj).init(k))[0],
                            jax.random.PRNGKey(0))
    mt = build_model(reduced_config("phi4-mini-3.8b"))
    pt = mt.init(0, device="cpu")
    flat_j = {jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
              for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat_t = {jax.tree_util.keystr(p): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
              for p, t in jax.tree_util.tree_flatten_with_path(pt)[0]}
    assert flat_t == flat_j
    big = build_model(dataclasses.replace(mt.cfg, n_heads=8, head_dim=64, d_model=512))
    wo = big.init(1, device="cpu")["layers"]["b0"]["attn"]["wo"]
    assert abs(float(wo.std()) / 8 ** -0.5 - 1) < 0.02          # 1/√H, not 1/√(H·Dh)
    table = big.init(1, device="cpu")["embed"]["table"]
    assert abs(float(table.std()) / 512 ** -0.5 - 1) < 0.02
    held = mt.init(torch.Generator().manual_seed(0), device="cpu",
                   dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(held))
    np.testing.assert_array_equal(held["embed"]["table"].float().numpy(),
                                  pt["embed"]["table"].to(torch.bfloat16).float().numpy())


def test_params_round_trip_through_numpy():
    _, pj, _, pt = _pair()
    back = convert.lm_params_to_numpy(pt)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(pj)[0], jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))


# (arch, overrides): recurrentgemma at 8 layers has two tail layers past its
# two (rglru, rglru, local_attn) groups, as the published 38 has past 12.
FAMILY_TREES = {"olmoe-1b-7b": {}, "rwkv6-1.6b": {}, "recurrentgemma-9b": {"n_layers": 8},
                "whisper-base": {}, "paligemma-3b": {}}


@pytest.mark.parametrize("arch", sorted(FAMILY_TREES))
def test_family_trees_match_the_reference_and_round_trip(arch):
    """The port's init tree has the reference's keys, shapes and dtypes
    (``moe``, ``tmix``, ``cmix``, ``rec``, ``cross``, ``ln_cross``,
    ``encoder``, ``tail{j}``); the reference's values go through
    ``lm_params_from_numpy`` / ``lm_params_to_numpy`` bit for bit; held in
    bf16, the leaves the reference reads in f32 stay f32."""
    from repro_torch.models.model import F32_LEAVES

    over = FAMILY_TREES[arch]
    mj = jax_build_model(jax_reduced_config(arch, **over))
    mt = build_model(reduced_config(arch, **over))
    pj = jax.tree.map(np.asarray, unzip(mj.init(jax.random.PRNGKey(3)))[0])
    flat = lambda tree: {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype).split(".")[-1])
                         for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(mt.init(0, device="cpu")) == flat(pj)
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(pj, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(pj), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    held = mt.init(0, device="cpu", dtype=torch.bfloat16)
    for path, t in jax.tree_util.tree_flatten_with_path(held)[0]:
        want = torch.float32 if path[-1].key in F32_LEAVES else torch.bfloat16
        assert t.dtype == want, jax.tree_util.keystr(path)


def test_serve_main_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", "phi4-mini-3.8b", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "6", "--gen", "5", "--seed", "1"])
    text = capsys.readouterr().out
    assert "serving OK" in text and "phi4-mini-3.8b on cpu" in text
    assert out["generated"].shape == (2, 5)
    assert bool(torch.isfinite(out["prompt_logits"]).all())
    # The prompt's last logits through decode equal those of the prefill step.
    pre = training.make_prefill_step(out["model"])(out["params"], {"tokens": out["prompt"]})
    np.testing.assert_allclose(out["prompt_logits"].numpy(), pre.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("flag,want_layers", [([], 2), (["--no-reduced"], 32)])
def test_serve_reduced_flag_is_switchable(monkeypatch, flag, want_layers):
    from repro_torch.launch import serve

    seen = {}

    class Stop(Exception):
        pass

    def capture(cfg):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(serve, "build_model", capture)
    with pytest.raises(Stop):
        serve.main(["--arch", "phi4-mini-3.8b", "--device", "cpu", *flag])
    assert seen["cfg"].n_layers == want_layers
    if flag:
        assert seen["cfg"] == get_config("phi4-mini-3.8b")


def test_loss_raises_and_configs_are_the_reference_copies():
    """(The name is kept from the slice that had no ``Model.loss``, when the
    port's raised.)  ``Model.loss`` runs and equals the reference's on
    reduced phi4-mini (f32, carried weights; loss and metrics ``rtol=1e-6``,
    ``tokens`` exact); the configs are copies of the reference's."""
    mj, pj, mt, pt = _pair(jax_impl="reference")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, mj.cfg.vocab_size, (2, 21)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    want, met_w = mj.loss(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, met = mt.loss(pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for k in ("ce", "zloss", "aux"):
        np.testing.assert_allclose(float(met[k]), float(met_w[k]), rtol=1e-6, atol=1e-12)
    assert float(met["tokens"]) == float(met_w["tokens"]) == 40.0
    from repro.configs import ARCHS as JAX_ARCHS

    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name, cfg in ARCHS.items():
        ref = dataclasses.asdict(JAX_ARCHS[name])
        assert dataclasses.asdict(cfg) == ref, name
    assert get_config("phi4-mini-3.8b").params_dense() == JAX_ARCHS["phi4-mini-3.8b"].params_dense()
