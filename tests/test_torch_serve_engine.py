"""The port's serving path against the JAX package's, on the CPU.

Greedy ``generate`` and ``ServeEngine.run`` (5 requests over 4 slots:
two bursts, the second padded with zero prompts) must return the
reference's tokens for the reference's parameters and the same
``SyntheticLM`` prompts; where a reference step's top-2 logits lie
within 1e-4 (relative) the comparison teacher-forces from that step
(``torch_lm_reference.assert_greedy_matches``).  The launcher runs on
the CPU when asked.
"""

import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as RefSyntheticLM
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import generate as ref_generate
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import ServeEngine, generate
from torch_lm_reference import (assert_greedy_matches, build_pair,
                                numpy_batch, to_jax, to_torch)

GENERATE_ARCHS = ["gemma2-9b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                  "zamba2-2.7b"]
ENGINE_ARCHS = ["qwen2-0.5b", "zamba2-2.7b"]


@pytest.fixture(scope="module")
def pairs():
    return {a: build_pair(a) for a in GENERATE_ARCHS + ENGINE_ARCHS}


@pytest.mark.parametrize("arch", GENERATE_ARCHS)
def test_greedy_generate_matches_reference(pairs, arch):
    pair = pairs[arch]
    batch = {"tokens": numpy_batch(pair.cfg, 3, 7, seed=1)["tokens"]}
    ref = np.asarray(ref_generate(pair.ref, pair.ref_params, to_jax(batch),
                                  max_new=6))
    got = generate(pair.port, to_torch(batch), max_new=6)
    assert got.shape == (3, 6) and got.dtype == torch.int64
    assert_greedy_matches(pair, batch, ref, got.numpy())


def _prompts(cfg, n, seq):
    port = SyntheticLM(vocab=cfg.vocab, seed=0).batch(
        step=0, shard=0, n_shards=1, batch=n, seq=seq)["tokens"]
    ref = RefSyntheticLM(vocab=cfg.vocab, seed=0).batch(
        step=0, shard=0, n_shards=1, batch=n, seq=seq)["tokens"]
    assert port.tobytes() == ref.tobytes()
    return port


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_run_matches_reference(pairs, arch):
    """5 requests over 4 slots, prompt_len 8: prompts of 5-10 tokens
    (left-padded with 0, or cut to their last 8), max_new 6; request 3
    asks for 4 tokens only."""
    pair = pairs[arch]
    prompts = _prompts(pair.cfg, 5, 10)
    lens = [10, 5, 8, 6, 9]
    ref_eng = RefServeEngine(pair.ref, pair.ref_params, slots=4,
                             prompt_len=8, max_new=6)
    eng = ServeEngine(pair.port, slots=4, prompt_len=8, max_new=6)
    for e in (ref_eng, eng):
        for rid, n in enumerate(lens):
            e.submit(rid, prompts[rid, :n], max_new=4 if rid == 3 else None)
    ref_out = ref_eng.run()
    out = eng.run()
    assert sorted(out) == sorted(ref_out) == list(range(5))
    assert [len(out[r]) for r in range(5)] == [6, 6, 6, 4, 6]
    # each burst as the engines batch it: the port's greedy tokens
    # against the reference's, and each engine against its own generate
    for rids in ([0, 1, 2, 3], [4]):
        padded = np.stack([eng._pad(prompts[r, :lens[r]]) for r in rids]
                          + [np.zeros(8, np.int32)] * (4 - len(rids)))
        assert np.array_equal(padded, np.stack(
            [ref_eng._pad(prompts[r, :lens[r]]) for r in rids]
            + [np.zeros(8, np.int32)] * (4 - len(rids))))
        batch = {"tokens": padded}
        # each engine's own generate (greedy: the key is not read)
        ref = np.asarray(ref_eng._gen(pair.ref_params, to_jax(batch),
                                      ref_eng._key))
        got = eng._gen(to_torch(batch)).numpy()
        assert_greedy_matches(pair, batch, ref, got)
        for i, r in enumerate(rids):
            n = 4 if r == 3 else 6
            assert ref_out[r] == ref[i, :n].tolist()
            assert out[r] == got[i, :n].tolist()


def test_temperature_sampling_is_seeded(pairs):
    pair = pairs["qwen2-0.5b"]
    batch = to_torch({"tokens": numpy_batch(pair.cfg, 2, 5, seed=2)
                      ["tokens"]})

    def draw(seed):
        return generate(pair.port, batch, max_new=6, temperature=1.0,
                        generator=torch.Generator().manual_seed(seed))

    a, b = draw(1), draw(1)
    assert torch.equal(a, b)
    assert a.shape == (2, 6)
    assert int(a.min()) >= 0 and int(a.max()) < pair.cfg.vocab
    assert not torch.equal(a, draw(2))


def test_launch_serve_runs_on_cpu(capsys):
    results = launch_serve.run("qwen2-0.5b-smoke", requests=5, slots=4,
                               prompt_len=8, max_new=4, device="cpu")
    assert sorted(results) == list(range(5))
    assert all(len(v) == 4 and all(0 <= t < 256 for t in v)
               for v in results.values())
    assert "[serve] qwen2-0.5b-smoke on cpu: 5 requests x 4" in (
        capsys.readouterr().out)


def test_launch_serve_cli_takes_device(capsys):
    launch_serve.main(["--arch", "mamba2-780m-smoke", "--requests", "2",
                       "--slots", "2", "--prompt-len", "4", "--max-new",
                       "2", "--device", "cpu"])
    assert "mamba2-780m-smoke on cpu" in capsys.readouterr().out
