"""The CLIP-L / T5 text encoders in the port (``unitex_torch/models/text.py``,
``models/text_encoders.py``), the masked branch of ``flux/layers.sdpa`` and
the FLUX launcher's ``--prompt``, against the JAX package, on the CPU.

Trees come from the JAX init (tiny configs) and cross with
``params_from_jax``; every forward is f32 (the port's without TF32) and is
held to 1e-5 absolute (hidden states of order 1: the two sum in other
orders, about 1e-7 a value).  The T5 bucket ids must be equal as integers;
the converters give equal trees (a copy, no arithmetic).  The repo has no
vocabulary files, so the encoders' tokenizers are stubs returning fixed
ids, in a stand-in ``transformers`` module for both packages.  JAX references run
jitted, each compiled once for the module.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitex_tpu.models import text_encoders as jenc
from unitex_tpu.models import text_jax as jtext

from unitex_torch.models import text as ttext
from unitex_torch.models import text_encoders as tenc
from unitex_torch.scripts import train_flux_lora as launcher
from unitex_torch.utils.params import params_from_jax
from torch_cpu_share import share_cpu
from torch_jax_reference import jit_reference

share_cpu()

TOL = 1e-5
# CLIP's head count is not in its state dict (CLIP-L's 12 are assumed) and
# its EOS id is CLIP-L's; T5's width is FluxConfig.tiny()'s prompt width
CLIP_TINY = jtext.CLIPTextConfig(vocab_size=100, hidden_size=48, num_layers=2,
                                 mlp_dim=64)
T5_TINY = jtext.T5EncoderConfig(vocab_size=100, d_model=64, d_kv=8, d_ff=96,
                                num_layers=2, num_heads=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tcfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("S", [7, 77, 512])
def test_relative_buckets_equal_jax(S):
    want = jit_reference(jtext._t5_relative_buckets, static_argnums=(0, 1, 2))(S, 32, 128)
    got = ttext._t5_relative_buckets(S, 32, 128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _seeded(init, cfg, seed):
    """The port's seeded tree as numpy (the JAX inits compile for
    seconds; ``test_seeded_inits_have_the_jax_layout`` holds the layout)."""
    cls = ttext.CLIPTextConfig if isinstance(cfg, jtext.CLIPTextConfig) \
        else ttext.T5EncoderConfig
    return jax.tree.map(lambda t: t.numpy(), init(
        torch.Generator().manual_seed(seed), _tcfg(cls, cfg), device="cpu"))


@pytest.fixture(scope="module")
def clip_tree():
    return _seeded(ttext.init_clip_text_params, CLIP_TINY, 1)


@pytest.mark.parametrize("gated", [True, False], ids=["gated_gelu", "relu"])
def test_seeded_inits_have_the_jax_layout(gated):
    t5 = dataclasses.replace(T5_TINY, gated_act=gated)
    for jinit, tinit, cfg in (
            (jtext.init_clip_text_params, ttext.init_clip_text_params, CLIP_TINY),
            (jtext.init_t5_encoder_params, ttext.init_t5_encoder_params, t5)):
        want = jax.eval_shape(lambda: jinit(jax.random.key(0), cfg))
        got = _seeded(tinit, cfg, 0)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype


EOS = 99   # the tiny tower's end token in the forward tests


def _clip_ids(S=16, B=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, EOS, (B, S)).astype(np.int32)
    ids[0, 5:] = EOS
    ids[1, 11] = EOS
    return ids


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_forward_matches_jax(clip_tree, act):
    """Causal attention through sdpa's masked branch, pooling at the
    first EOS (row 0 at 5, row 1 at 11)."""
    cfg = dataclasses.replace(CLIP_TINY, hidden_act=act, eos_token_id=EOS)
    ids = _clip_ids()
    want = jit_reference(jtext.clip_text_forward, static_argnums=1)(clip_tree, cfg, ids)
    got = ttext.clip_text_forward(params_from_jax(clip_tree, "cpu"),
                                  _tcfg(ttext.CLIPTextConfig, cfg), _t(ids))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), got[0].numpy()[[0, 1], [5, 11]])


@pytest.mark.parametrize("gated", [True, False], ids=["gated_gelu", "relu"])
@pytest.mark.parametrize("masked", [False, True], ids=["ids_only", "mask"])
def test_t5_forward_matches_jax(gated, masked):
    cfg = dataclasses.replace(T5_TINY, gated_act=gated)
    tree = _seeded(ttext.init_t5_encoder_params, cfg, 2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 100, (2, 24)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((2, 24), np.int32)
        mask[0, 17:] = 0
        mask[1, 9:] = 0
    want = jit_reference(jtext.t5_encoder_forward, static_argnums=1)(tree, cfg, ids, mask)
    got = ttext.t5_encoder_forward(
        params_from_jax(tree, "cpu"), _tcfg(ttext.T5EncoderConfig, cfg), _t(ids),
        None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def _hf_state_dict(kind, seed, gated=True):
    """A seeded HF-named numpy state dict of a tiny CLIP or T5."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {}
    if kind == "clip":
        c = CLIP_TINY
        d, p = c.hidden_size, "text_model."
        sd[p + "embeddings.token_embedding.weight"] = a(c.vocab_size, d)
        sd[p + "embeddings.position_embedding.weight"] = a(c.max_positions, d)
        for i in range(c.num_layers):
            pre = f"{p}encoder.layers.{i}."
            for ln in ("layer_norm1", "layer_norm2"):
                sd[pre + ln + ".weight"], sd[pre + ln + ".bias"] = a(d), a(d)
            for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[pre + f"self_attn.{m}.weight"] = a(d, d)
                sd[pre + f"self_attn.{m}.bias"] = a(d)
            sd[pre + "mlp.fc1.weight"], sd[pre + "mlp.fc1.bias"] = a(c.mlp_dim, d), a(c.mlp_dim)
            sd[pre + "mlp.fc2.weight"], sd[pre + "mlp.fc2.bias"] = a(d, c.mlp_dim), a(d)
        sd[p + "final_layer_norm.weight"], sd[p + "final_layer_norm.bias"] = a(d), a(d)
        return sd
    c = T5_TINY
    d, inner = c.d_model, c.num_heads * c.d_kv
    sd["shared.weight"] = a(c.vocab_size, d)
    for i in range(c.num_layers):
        pre = f"encoder.block.{i}.layer."
        sd[pre + "0.layer_norm.weight"] = a(d)
        for m in "qkv":
            sd[pre + f"0.SelfAttention.{m}.weight"] = a(inner, d)
        sd[pre + "0.SelfAttention.o.weight"] = a(d, inner)
        if i == 0:
            sd[pre + "0.SelfAttention.relative_attention_bias.weight"] = a(
                c.relative_buckets, c.num_heads)
        sd[pre + "1.layer_norm.weight"] = a(d)
        for m in (("wi_0", "wi_1") if gated else ("wi",)):
            sd[pre + f"1.DenseReluDense.{m}.weight"] = a(c.d_ff, d)
        sd[pre + "1.DenseReluDense.wo.weight"] = a(d, c.d_ff)
    sd["encoder.final_layer_norm.weight"] = a(d)
    return sd


@pytest.mark.parametrize("kind,gated", [("clip", True), ("t5", True),
                                        ("t5", False)],
                         ids=["clip", "t5_gated", "t5_relu"])
def test_converters_match_jax(tmp_path, kind, gated):
    """``*_config_from_sd`` and ``convert_*`` on a seeded HF-named state
    dict: the JAX package's config and tree, from the dict and from a
    safetensors file read lazily (shapes from its header)."""
    from safetensors.numpy import save_file

    from unitex_torch.models.flux.loader import iter_safetensors

    sd = _hf_state_dict(kind, seed=4, gated=gated)
    jfrom, jconv, tfrom, tconv = (
        (jtext.clip_config_from_sd, jtext.convert_clip_text,
         ttext.clip_config_from_sd, ttext.convert_clip_text) if kind == "clip"
        else (jtext.t5_config_from_sd, jtext.convert_t5_encoder,
              ttext.t5_config_from_sd, ttext.convert_t5_encoder))
    jcfg = jfrom(sd)
    want = jax.tree.leaves(_np_tree(jconv(sd, jcfg)))
    save_file(sd, str(tmp_path / "model.safetensors"))
    with iter_safetensors(str(tmp_path)) as lazy:
        for source in (sd, lazy):
            cfg = tfrom(source)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            tree = tconv(source, cfg, device="cpu")
            leaves = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), tree))
            assert len(leaves) == len(want)
            for g, w in zip(leaves, want):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)


def test_sdpa_masked_branch_matches_jax_and_launches_no_kernel(monkeypatch):
    """``sdpa(mask=...)`` is ``jax.nn.dot_product_attention`` with the
    same mask (f32 and bf16 inputs), and never reaches the kernel
    wrapper."""
    from unitex_torch.models.flux.layers import sdpa
    from unitex_torch.ops import attention

    def refuse(*a, **k):
        raise AssertionError("a masked sdpa reached the kernel wrapper")

    monkeypatch.setattr(attention, "attention", refuse)
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 12, 4, 8)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(size=(2, 1, 12, 12)) < 0.6
    mask[..., 0] = True
    want = jit_reference(lambda q, k, v, m: jax.nn.dot_product_attention(q, k, v, mask=m))
    for dtype, jdt, tol in ((torch.float32, jnp.float32, TOL),
                            (torch.bfloat16, jnp.bfloat16, 2e-2)):
        w = want(*(jnp.asarray(x, jdt) for x in (q, k, v)), mask)
        g = sdpa(*(_t(x).to(dtype) for x in (q, k, v)), mask=_t(mask))
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=tol, rtol=0)


class _StubTokenizer:
    """Fixed ids of a prompt, padded to ``max_length`` (the last id is the
    tokenizer's end token, as CLIP's and T5's are)."""

    def __init__(self, eos):
        self.eos = eos

    def __call__(self, prompts, padding, max_length, truncation, **kw):
        class Out:
            pass

        out = Out()
        out.input_ids = [[(7 * j + len(p)) % self.eos if j < 6 else self.eos
                          for j in range(max_length)] for p in prompts]
        return out


@pytest.fixture
def text_root(tmp_path, monkeypatch):
    """``<root>/flux`` with the tiny CLIP's and T5's safetensors and empty
    tokenizer directories; ``transformers`` stands in as a module whose
    two tokenizer classes load the stubs (the real package takes seconds
    to import and has no vocabulary here)."""
    import types

    from safetensors.numpy import save_file

    flux = tmp_path / "models" / "flux"
    for name, kind in (("text_encoder", "clip"), ("text_encoder_2", "t5")):
        (flux / name).mkdir(parents=True)
        save_file(_hf_state_dict(kind, seed=6), str(flux / name / "model.safetensors"))
    for name in ("tokenizer", "tokenizer_2"):
        (flux / name).mkdir()

    def tokenizer(eos):
        return type("Tokenizer", (), {"from_pretrained": classmethod(
            lambda cls, path, **kw: _StubTokenizer(eos))})

    fake = types.ModuleType("transformers")
    fake.CLIPTokenizer, fake.T5TokenizerFast = tokenizer(99), tokenizer(1)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    return str(tmp_path / "models")


def test_device_encoders_match_jax_encoders(text_root):
    want = jenc.JaxFluxTextEncoders(text_root, max_sequence_length=24)(["[MVFLUX]"])
    enc = tenc.build_text_encoders(text_root, 24, device="cpu")
    assert isinstance(enc, tenc.DeviceFluxTextEncoders)
    got = enc("[MVFLUX]")
    assert [tuple(x.shape) for x in got] == [(1, 24, 64), (1, 48)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0)
    with pytest.raises(NotImplementedError, match="mesh"):
        tenc.DeviceFluxTextEncoders(text_root, mesh=object(), device="cpu")


def test_build_text_encoders_falls_back_as_jax(tmp_path, capsys):
    """No root: None.  A root without the encoders: the device backend
    fails, then the HF one, each with the JAX package's message, and the
    callers take zero embeddings; ``backend='torch'`` tries only HF."""
    assert tenc.build_text_encoders(None) is None
    root = str(tmp_path)
    assert tenc.build_text_encoders(root, device="cpu") is None
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    assert out[0].startswith("[text] device encoders unavailable (no tokenizer")
    assert out[0].endswith("); trying torch")
    assert out[1].startswith("[text] encoders unavailable (")
    assert out[1].endswith("); using null embeddings")
    assert tenc.build_text_encoders(root, backend="torch", device="cpu") is None
    assert capsys.readouterr().out.startswith("[text] encoders unavailable (")
    seq, pooled = tenc.zero_embeddings()
    want = jenc.zero_embeddings()
    assert seq.shape == want[0].shape and pooled.shape == want[1].shape
    assert not seq.any() and not pooled.any()


def test_launcher_embeds_the_prompt(text_root, tmp_path, monkeypatch, capsys):
    """``--pretrain-models`` with the text encoders: the batch carries the
    prompt's embeddings (T5's 512 x 64 sequence, CLIP's pooled 48: the
    tiny FLUX's prompt width and a pooled width set to CLIP's); with other
    widths, or ``--prompt ''``, zeros and (for the widths) the JAX
    launcher's message."""
    from unitex_torch.models.flux.config import FluxConfig

    tiny = dataclasses.replace(FluxConfig.tiny(), pooled_projection_dim=48)
    monkeypatch.setattr(FluxConfig, "tiny", classmethod(lambda cls: tiny))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = []
    build = launcher.build_batch
    monkeypatch.setattr(launcher, "build_batch", lambda ex, vp, vc, seq, pooled, *a:
                        seen.append((seq, pooled)) or build(ex, vp, vc, seq,
                                                            pooled, *a))
    launcher.main(["--tiny", "--device", "cpu", "--pretrain-models", text_root,
                   "--max-train-steps", "1", "--lr-scheduler", "constant",
                   "--output-dir", str(tmp_path / "run")])
    want = tenc.build_text_encoders(text_root, device="cpu")("[MVFLUX]")
    assert len(seen) == 1
    for g, w in zip(seen[0], want):
        assert torch.equal(g, w[0])
    cfg = dataclasses.replace(tiny, joint_attention_dim=40)
    args = launcher.parse_args(["--pretrain-models", text_root])
    seq, pooled = launcher.prompt_embeddings(args, cfg, torch.device("cpu"))
    assert "text-encoder dims do not match" in capsys.readouterr().out
    assert seq.shape == (512, 40) and pooled.shape == (48,)
    assert not seq.any() and not pooled.any()
    args = launcher.parse_args(["--pretrain-models", text_root, "--prompt", ""])
    seq, _ = launcher.prompt_embeddings(args, tiny, torch.device("cpu"))
    assert seq.shape == (512, 64) and not seq.any()
    assert launcher.parse_args([]).prompt == "[MVFLUX]"
