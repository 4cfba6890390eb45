"""The yardstick is frozen: the generator gives the same bytes for a
seed, and the operation counts equal hand counts at a small shape."""

import hashlib

import numpy as np

from perfbench import flops
from perfbench.generators import token_rows

TRAIN = {"batch": 3, "seq_len": 50}


def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def test_token_rows_are_pinned_by_seed():
    a = token_rows(TRAIN, 2**31 + 5, 3, 1000)
    b = token_rows(TRAIN, 2**31 + 5, 3, 1000)
    assert _digest(a["tokens"], a["targets"]) == _digest(b["tokens"], b["targets"])
    assert _digest(a["tokens"], a["targets"]) == PINNED
    assert (a["tokens"][:, 1:] == a["targets"][:, :-1]).all()
    assert a["tokens"].dtype == np.int32 and a["tokens"].shape == (3, 50)
    assert a["tokens"].min() >= 1 and a["tokens"].max() < 1000
    c = token_rows(TRAIN, 2**31 + 6, 3, 1000)
    assert not (a["tokens"] == c["tokens"]).all()


SMALL = {"family": "ssm", "d_model": 4, "ssm_expand": 2, "ssm_state": 2,
         "ssm_head_dim": 2, "conv_kernel": 2, "ssm_chunk": 4, "vocab": 10,
         "n_layers": 1}


def test_mixer_counts_by_hand():
    # d 4, d_inner 8, H 4, N 2, P 2, K 2, chunk 4, one token of a row of 4:
    # in_proj 2*4*(16+4+4)=192, out_proj 2*8*4=64, conv 2*2*12=48,
    # within the chunk 2*(4+1)/2*(2+4*2)=50, states 2*2*4*2*2=64
    assert flops.mixer_flops_per_token(SMALL, 4) == 192 + 64 + 48 + 50 + 64


def test_step_counts_by_hand():
    # forward of 4 tokens: 418*4 in the mixer + logits 2*4*10*4
    assert flops.train_step_flops(SMALL, 1, 4) == 3 * (418 * 4 + 320)
    assert flops.train_step_flops(SMALL, 2, 4) == 6 * (418 * 4 + 320)


PINNED = "4d6da3651b8f15ba"
