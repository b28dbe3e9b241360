"""Cross-framework caption parity: torch reference algorithm vs icee_tpu.

No trained reference checkpoints exist in this environment (flagged in
BASELINE.md), so this is the strongest available proxy: build a torch
FactoredLSTM with the REFERENCE's module naming, run the REFERENCE's
shrinking-beam algorithm in torch (serving semantics, feature fed at
step 1 — the transcription in ``scripts/baseline_torch.py``), import the
state_dict through ``checkpoint/torch_import.py``, decode the SAME features
with icee_tpu's batched beam, and require IDENTICAL captions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

V, E, H, F = 96, 12, 16, 16
K, MAX_STEPS = 4, 7
GATES = ("i", "f", "o", "c")
STYLE_PREFIXES = ("f", "happy_", "sad_", "angry_")


def _torch_state_dict(seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {"B.weight": torch.randn(V, E, generator=g) * 0.5,
          "C.weight": torch.randn(V, H, generator=g) * 0.5,
          "C.bias": torch.randn(V, generator=g) * 0.1}
    for gate in GATES:
        sd[f"V_{gate}.weight"] = torch.randn(F, E, generator=g) * 0.4
        sd[f"V_{gate}.bias"] = torch.randn(F, generator=g) * 0.1
        sd[f"U_{gate}.weight"] = torch.randn(H, F, generator=g) * 0.4
        sd[f"U_{gate}.bias"] = torch.randn(H, generator=g) * 0.1
        sd[f"W_{gate}.weight"] = torch.randn(H, H, generator=g) * 0.4
        sd[f"W_{gate}.bias"] = torch.randn(H, generator=g) * 0.1
        for sp in STYLE_PREFIXES:
            sd[f"S_{sp}{gate}.weight"] = torch.randn(F, F, generator=g) * 0.4
            sd[f"S_{sp}{gate}.bias"] = torch.randn(F, generator=g) * 0.1
    return sd


def _torch_step(sd, style_prefix, x, h, c):
    """The reference FactoredLSTM step (stylenet/model.py:115-155)."""
    def lin(name, inp):
        return inp @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]

    pre = {}
    for gate in GATES:
        v = lin(f"V_{gate}", x)
        s = lin(f"S_{style_prefix}{gate}", v)
        u = lin(f"U_{gate}", s)
        pre[gate] = u + lin(f"W_{gate}", h)
    i = torch.sigmoid(pre["i"])
    f = torch.sigmoid(pre["f"])
    o = torch.sigmoid(pre["o"])
    gg = torch.tanh(pre["c"])
    c = f * c + i * gg
    h = o * c  # reference quirk: no tanh
    return h, c


@torch.no_grad()
def _torch_beam(sd, style_prefix, feature, start=1, end=2):
    """The reference's shrinking beam (stylenet/model.py:198-294 serving
    semantics, app/backend/model.py:414-417): returns the best-scoring
    completed sequence (max raw score, earliest on ties)."""
    import torch.nn.functional as Fn

    k = K
    prev = torch.full((k, 1), start, dtype=torch.long)
    seqs = prev
    top_scores = torch.zeros(k, 1)
    h = torch.zeros(k, H)
    c = torch.zeros(k, H)
    complete, complete_scores = [], []
    step = 1
    while True:
        if step == 1:
            x = feature.expand(k, E)
        else:
            x = sd["B.weight"][prev.squeeze(1)]
        h, c = _torch_step(sd, style_prefix, x, h, c)
        scores = Fn.log_softmax(h @ sd["C.weight"].T + sd["C.bias"], dim=1)
        scores = top_scores.expand_as(scores) + scores
        if step == 1:
            top_scores, top_words = scores[0].topk(k, 0, True, True)
        else:
            top_scores, top_words = scores.view(-1).topk(k, 0, True, True)
        prev_idx = torch.div(top_words, V, rounding_mode="floor")
        words = top_words % V
        seqs = torch.cat([seqs[prev_idx], words.unsqueeze(1)], dim=1)
        incomplete = [i for i, w in enumerate(words) if w != end]
        done = sorted(set(range(len(words))) - set(incomplete))
        if done:
            complete.extend(seqs[done].tolist())
            complete_scores.extend(t.item() for t in top_scores[done])
        k -= len(done)
        if k == 0:
            break
        seqs = seqs[incomplete]
        h = h[prev_idx[incomplete]]
        c = c[prev_idx[incomplete]]
        top_scores = top_scores[incomplete].unsqueeze(1)
        prev = words[incomplete].unsqueeze(1)
        if step > MAX_STEPS:
            break
        step += 1
    if not complete:
        return [end], float("-inf")
    best = int(np.argmax(complete_scores))
    return complete[best], complete_scores[best]


@pytest.mark.parametrize("style_idx,style_prefix",
                         [(0, "f"), (1, "happy_")])
def test_torch_reference_beam_matches_icee(rng, style_idx, style_prefix):
    from icee_tpu.checkpoint.torch_import import (
        import_factored_decoder_state_dict,
    )
    from icee_tpu.decode.fast import beam_fn

    sd = _torch_state_dict()
    params = import_factored_decoder_state_dict(sd)

    batch = 4
    feats_t = torch.randn(batch, E, generator=torch.Generator().manual_seed(7))
    feats_j = jnp.asarray(feats_t.numpy())

    # torch reference algorithm, one image at a time
    want = [_torch_beam(sd, style_prefix, feats_t[i:i + 1])
            for i in range(batch)]

    # icee_tpu: the batched beam, serving semantics
    res = beam_fn("stylenet", params, batch, K, MAX_STEPS, V, 1, 2,
                  feed_feature=True)(feats_j, style_idx)

    for i in range(batch):
        want_tokens, want_score = want[i]
        got = np.asarray(res.tokens[i][: int(res.length[i])]).tolist()
        assert got == want_tokens, (
            f"img {i}: torch {want_tokens} != icee {got}")
        if np.isfinite(want_score):
            np.testing.assert_allclose(float(res.score[i]), want_score,
                                       rtol=1e-4)


# --- NIC (torch's own nn.LSTMCell: exact reference semantics) ---------------

@torch.no_grad()
def _torch_nic_beam(sd, cell, feature, start=1, end=2):
    import torch.nn.functional as Fn

    k = K
    prev = torch.full((k,), start, dtype=torch.long)
    seqs = prev.unsqueeze(1)
    top_scores = torch.zeros(k, 1)
    h = torch.zeros(k, H)
    c = torch.zeros(k, H)
    complete, complete_scores = [], []
    step = 1
    while True:
        x = feature.expand(k, E) if step == 1 else sd["embed.weight"][prev]
        h, c = cell(x, (h, c))
        scores = Fn.log_softmax(
            h @ sd["linear.weight"].T + sd["linear.bias"], dim=1)
        scores = top_scores.expand_as(scores) + scores
        if step == 1:
            top_scores, top_words = scores[0].topk(k, 0, True, True)
        else:
            top_scores, top_words = scores.view(-1).topk(k, 0, True, True)
        prev_idx = torch.div(top_words, V, rounding_mode="floor")
        words = top_words % V
        seqs = torch.cat([seqs[prev_idx], words.unsqueeze(1)], dim=1)
        incomplete = [i for i, w in enumerate(words) if w != end]
        done = sorted(set(range(len(words))) - set(incomplete))
        if done:
            complete.extend(seqs[done].tolist())
            complete_scores.extend(t.item() for t in top_scores[done])
        k -= len(done)
        if k == 0:
            break
        seqs = seqs[incomplete]
        h = h[prev_idx[incomplete]]
        c = c[prev_idx[incomplete]]
        top_scores = top_scores[incomplete].unsqueeze(1)
        prev = words[incomplete]
        if step > MAX_STEPS:
            break
        step += 1
    if not complete:
        return [end], float("-inf")
    best = int(np.argmax(complete_scores))
    return complete[best], complete_scores[best]


def test_torch_nic_beam_matches_icee(rng):
    import torch.nn as nn

    from icee_tpu.checkpoint.torch_import import import_nic_decoder_state_dict
    from icee_tpu.decode.fast import beam_fn

    torch.manual_seed(5)
    cell = nn.LSTMCell(E, H)
    sd = {"embed.weight": torch.randn(V, E) * 0.5,
          "lstm.weight_ih": cell.weight_ih.data,
          "lstm.weight_hh": cell.weight_hh.data,
          "lstm.bias_ih": cell.bias_ih.data,
          "lstm.bias_hh": cell.bias_hh.data,
          "linear.weight": torch.randn(V, H) * 0.5,
          "linear.bias": torch.randn(V) * 0.1}
    params = import_nic_decoder_state_dict(sd)

    batch = 3
    feats_t = torch.randn(batch, E, generator=torch.Generator().manual_seed(8))
    feats_j = jnp.asarray(feats_t.numpy())

    want = [_torch_nic_beam(sd, cell, feats_t[i:i + 1])
            for i in range(batch)]
    res = beam_fn("nic", params, batch, K, MAX_STEPS, V, 1, 2)(feats_j, 0)
    for i in range(batch):
        got = np.asarray(res.tokens[i][: int(res.length[i])]).tolist()
        assert got == want[i][0], f"img {i}: {want[i][0]} != {got}"


# --- StyleNet+Att (reference model_att.py:307-426 transcription) ------------

P_PIX, A_DIM, FS = 6, 10, 14


def _att_state_dict(seed=3):
    g = torch.Generator().manual_seed(seed)
    sd = _torch_state_dict(seed)
    # widen V_* to the concat input [emb ; gated context]
    for gate in GATES:
        sd[f"V_{gate}.weight"] = torch.randn(F, E + FS, generator=g) * 0.4
    for a in ("attention", "attention_happy", "attention_sad",
              "attention_angry"):
        sd[f"{a}.encoder_att.weight"] = torch.randn(A_DIM, FS, generator=g) * .4
        sd[f"{a}.encoder_att.bias"] = torch.randn(A_DIM, generator=g) * 0.1
        sd[f"{a}.decoder_att.weight"] = torch.randn(A_DIM, H, generator=g) * .4
        sd[f"{a}.decoder_att.bias"] = torch.randn(A_DIM, generator=g) * 0.1
        sd[f"{a}.full_att.weight"] = torch.randn(1, A_DIM, generator=g) * 0.4
        sd[f"{a}.full_att.bias"] = torch.randn(1, generator=g) * 0.1
    for n, shp in (("init_h", (H, FS)), ("init_c", (H, FS)),
                   ("f_beta", (FS, H))):
        sd[f"{n}.weight"] = torch.randn(*shp, generator=g) * 0.4
        sd[f"{n}.bias"] = torch.randn(shp[0], generator=g) * 0.1
    return sd


@torch.no_grad()
def _torch_att_beam(sd, att_name, style_prefix, features, start=1, end=2):
    """model_att.py:307-426: init from mean features, embed(start) at
    step 1, per-style attention + f_beta gate, concat input."""
    import torch.nn.functional as Fn

    def lin(name, inp):
        return inp @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]

    k = K
    feats = features.expand(k, P_PIX, FS)
    prev = torch.full((k,), start, dtype=torch.long)
    seqs = prev.unsqueeze(1)
    top_scores = torch.zeros(k, 1)
    mean = feats.mean(dim=1)
    h = lin("init_h", mean)
    c = lin("init_c", mean)
    complete, complete_scores = [], []
    step = 1
    while True:
        emb = sd["B.weight"][prev]
        att1 = lin(f"{att_name}.encoder_att", feats)       # (k, P, A)
        att2 = lin(f"{att_name}.decoder_att", h)           # (k, A)
        e = lin(f"{att_name}.full_att",
                torch.relu(att1 + att2.unsqueeze(1))).squeeze(2)
        alpha = Fn.softmax(e, dim=1)
        awe = (feats * alpha.unsqueeze(2)).sum(dim=1)
        gate = torch.sigmoid(lin("f_beta", h))
        x = torch.cat([emb, gate * awe], dim=1)
        h, c = _torch_step(sd, style_prefix, x, h, c)
        scores = Fn.log_softmax(h @ sd["C.weight"].T + sd["C.bias"], dim=1)
        scores = top_scores.expand_as(scores) + scores
        if step == 1:
            top_scores, top_words = scores[0].topk(k, 0, True, True)
        else:
            top_scores, top_words = scores.view(-1).topk(k, 0, True, True)
        prev_idx = torch.div(top_words, V, rounding_mode="floor")
        words = top_words % V
        seqs = torch.cat([seqs[prev_idx], words.unsqueeze(1)], dim=1)
        incomplete = [i for i, w in enumerate(words) if w != end]
        done = sorted(set(range(len(words))) - set(incomplete))
        if done:
            complete.extend(seqs[done].tolist())
            complete_scores.extend(t.item() for t in top_scores[done])
        k -= len(done)
        if k == 0:
            break
        feats = feats[:k]
        seqs = seqs[incomplete]
        h = h[prev_idx[incomplete]]
        c = c[prev_idx[incomplete]]
        top_scores = top_scores[incomplete].unsqueeze(1)
        prev = words[incomplete]
        if step > MAX_STEPS:
            break
        step += 1
    if not complete:
        return [end], float("-inf")
    best = int(np.argmax(complete_scores))
    return complete[best], complete_scores[best]


def test_torch_attention_beam_matches_icee(rng):
    from icee_tpu.checkpoint.torch_import import (
        import_factored_att_decoder_state_dict,
    )
    from icee_tpu.decode.fast import beam_fn

    sd = _att_state_dict()
    params = import_factored_att_decoder_state_dict(sd)
    batch = 3
    feats_t = torch.randn(batch, P_PIX, FS,
                          generator=torch.Generator().manual_seed(9))
    feats_j = jnp.asarray(feats_t.numpy())

    want = [_torch_att_beam(sd, "attention_happy", "happy_",
                            feats_t[i:i + 1]) for i in range(batch)]
    res = beam_fn("stylenet_att", params, batch, K, MAX_STEPS, V, 1,
                  2)(feats_j, 1)
    for i in range(batch):
        got = np.asarray(res.tokens[i][: int(res.length[i])]).tolist()
        assert got == want[i][0], f"img {i}: {want[i][0]} != {got}"
