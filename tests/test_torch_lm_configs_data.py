"""The port's configs, data sources and model specs against the JAX
package's, on the CPU.

The registry lists the reference's ten archs with every
``ModelConfig`` field equal (full and ``.reduced()``); parameter counts
equal; the parameter tree of every full-width model (built on the meta
device) has the reference's paths, shapes and dtypes; the input specs
agree; ``SyntheticLM`` batches are byte-identical for the same
``(seed, step, shard, n_shards, batch, seq)``, and so is the prefetching
``DataPipeline`` stream.  ``tests/test_models.py``'s parameter-count
checks and ``tests/test_substrate.py``'s data checks are mirrored.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as ref_configs
from repro.data import DataPipeline as RefDataPipeline
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import api as ref_api
from repro.utils import keystr_path as ref_keystr_path
from repro_torch import configs
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.models import api
from repro_torch.utils import keystr_path, leaves_with_paths

ARCHS = ref_configs.list_archs()


def test_list_archs_and_cells_equal_reference():
    assert configs.list_archs() == ARCHS and len(ARCHS) == 10
    assert configs.cells() == ref_configs.cells()
    assert [dataclasses.asdict(s) for s in configs.SHAPES] == [
        dataclasses.asdict(s) for s in ref_configs.SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch):
    ref, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(configs.get_config(arch + "-smoke"))
            == dataclasses.asdict(ref.reduced()))
    for method in ("hd", "expert_ff", "d_inner", "ssm_heads",
                   "sub_quadratic", "param_count", "active_param_count"):
        assert getattr(cfg, method)() == getattr(ref, method)(), method
    for shape in configs.SHAPES:
        assert shape.applicable(cfg) == ref_configs.get_shape(
            shape.name).applicable(ref)


def test_unknown_arch_and_shape_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")
    with pytest.raises(KeyError, match="unknown shape"):
        configs.get_shape("train_1m")


def test_param_counts_sane():
    """tests/test_models.py's nameplate check, in the port's configs."""
    approx = {
        "qwen2-0.5b": 0.5e9, "gemma2-9b": 9e9, "starcoder2-7b": 7e9,
        "nemotron-4-15b": 15e9, "kimi-k2-1t-a32b": 1.0e12,
        "phi3.5-moe-42b-a6.6b": 42e9, "mamba2-780m": 0.78e9,
        "qwen2-vl-72b": 72e9, "zamba2-2.7b": 2.7e9,
        "whisper-large-v3": 1.5e9,
    }
    for arch, want in approx.items():
        got = configs.get_config(arch).param_count()
        assert 0.5 * want < got < 1.8 * want, f"{arch}: {got:.2e} vs {want:.2e}"


def test_moe_active_params():
    cfg = configs.get_config("kimi-k2-1t-a32b")
    active = cfg.active_param_count()
    assert active < 0.1 * cfg.param_count()
    assert 15e9 < active < 60e9          # nameplate: ~32B active


def _ref_specs(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_keystr_path(kp): (tuple(v.shape), str(v.dtype))
            for kp, v in leaves}


def _port_specs(tree):
    return {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for path, t in leaves_with_paths(tree) if hasattr(t, "shape")}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_params_specs_match_reference(arch):
    """Every full-width model's tree on the meta device: the reference's
    paths, shapes (layers stacked on L; the hybrid's (sites, every)) and
    dtypes, with no storage."""
    cfg = configs.get_config(arch)
    got = api.params_specs(cfg)
    assert all(t.is_meta for _, t in leaves_with_paths(got))
    assert _port_specs(got) == _ref_specs(
        ref_api.params_specs(ref_configs.get_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    shape = configs.get_shape("decode_32k")
    ref_shape = ref_configs.get_shape("decode_32k")
    assert _port_specs(api.train_batch_specs(cfg, shape)) == _ref_specs(
        ref_api.train_batch_specs(ref_cfg, ref_shape))
    assert _port_specs(api.prefill_specs(cfg, shape)) == _ref_specs(
        ref_api.prefill_specs(ref_cfg, ref_shape))
    tokens, cache = api.decode_specs(cfg, shape)
    ref_tokens, ref_cache = ref_api.decode_specs(ref_cfg, ref_shape)
    assert (tuple(tokens.shape), tokens.is_meta) == (ref_tokens.shape, True)
    want = _ref_specs(ref_cache)
    assert want.pop("len") == ((), "int32") and cache["len"] == 0
    assert _port_specs(cache) == want


def test_keystr_path_is_the_references():
    tree = {"b": [np.zeros(1), {"x": np.zeros(2)}], "a": {"c": np.zeros(3)},
            "d": (np.zeros(4), None)}
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [ref_keystr_path(kp) for kp, _ in leaves]
    assert [p for p, _ in leaves_with_paths(tree)] == want
    assert want == ["a/c", "b/0", "b/1/x", "d/0"]
    assert keystr_path(("layers", "attn", 0)) == "layers/attn/0"


@pytest.mark.parametrize("seed,step,shard,n_shards,batch,seq,vocab", [
    (0, 0, 0, 1, 6, 128, 256000),     # the gemma2-9b serve prompts
    (0, 0, 0, 1, 6, 128, 32000),      # the zamba2-2.7b serve prompts
    (3, 7, 1, 2, 4, 16, 1000),
    (11, 123, 3, 4, 2, 33, 7),
])
def test_synthetic_lm_batches_byte_identical(seed, step, shard, n_shards,
                                             batch, seq, vocab):
    kw = dict(step=step, shard=shard, n_shards=n_shards, batch=batch,
              seq=seq)
    got = SyntheticLM(vocab=vocab, seed=seed).batch(**kw)
    want = RefSyntheticLM(vocab=vocab, seed=seed).batch(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_synthetic_deterministic_and_seekable():
    src = SyntheticLM(vocab=1000, seed=3)
    b1 = src.batch(step=7, shard=0, n_shards=2, batch=4, seq=16)
    b2 = src.batch(step=7, shard=0, n_shards=2, batch=4, seq=16)
    b3 = src.batch(step=8, shard=0, n_shards=2, batch=4, seq=16)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    b4 = src.batch(step=7, shard=1, n_shards=2, batch=4, seq=16)
    assert not np.array_equal(b1["tokens"], b4["tokens"])
    assert np.array_equal(b1["targets"][:, :-1], b1["tokens"][:, 1:])


def test_synthetic_has_structure():
    """Markov structure => repeated bigrams far above uniform chance."""
    toks = SyntheticLM(vocab=50000, seed=0).batch(
        step=0, shard=0, n_shards=1, batch=8, seq=512)["tokens"]
    bigrams = set()
    repeats = 0
    for row in toks:
        for a, c in zip(row[:-1], row[1:]):
            if (a, c) in bigrams:
                repeats += 1
            bigrams.add((a, c))
    assert repeats > 10      # uniform 50k^2 space would give ~0


def test_pipeline_stream_matches_reference_and_restarts():
    def stream(cls, src_cls, start=0, n=4):
        pipe = cls(src_cls(vocab=100, seed=1), global_batch=4, seq=8,
                   shard=1, n_shards=2, start_step=start, prefetch=2)
        try:
            return [next(pipe) for _ in range(n)], pipe.step
        finally:
            pipe.close()

    got, step = stream(DataPipeline, SyntheticLM)
    want, ref_step = stream(RefDataPipeline, RefSyntheticLM)
    assert step == ref_step == 4
    for g, w in zip(got, want):
        assert all(g[k].tobytes() == w[k].tobytes() for k in w)
    again, _ = stream(DataPipeline, SyntheticLM, start=2, n=2)
    for g, w in zip(again, got[2:]):
        assert g["tokens"].tobytes() == w["tokens"].tobytes()
    pipe = DataPipeline(SyntheticLM(vocab=100, seed=1), global_batch=4,
                        seq=8)
    first = next(pipe)
    pipe.seek(0)
    assert next(pipe)["tokens"].tobytes() == first["tokens"].tobytes()
    pipe.close()
