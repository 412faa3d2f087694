"""The port's int8 calibration against the JAX package's, on the CPU.

Both packages sweep the same batches through the tiny ViT with the same
weights. Alphas agree at rtol 1e-5: the moments are summed in f64 on both
sides, over activations that differ by f32 ulps between the packages
(tests/test_torch_models.py holds the shards at rtol 1e-4 per element;
summed over thousands of elements the relative difference of a moment is
far smaller). Weight scales come from identical weights through identical
quantizers and agree exactly. Sidecars cross-load both ways.
"""
import json

import numpy as np
import pytest
import torch

from pipeedge_tpu.models import layers as jlayers
from pipeedge_tpu.utils import calibrate as jcal
from pipeedge_tpu_torch import calibrate as tcal_entry
from pipeedge_tpu_torch.models import layers as tlayers
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.utils import calibrate as tcal

MODEL = "pipeedge/test-tiny-vit"
CFG = treg.get_model_config(MODEL)
TAGS = {"attn.q", "attn.k", "attn.v", "attn.out", "mlp.up", "mlp.down"}


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "tiny-vit.npz"
    np.savez(path, **tvit.random_npz_weights(CFG, seed=13))
    return str(path)


def _batches(n=2, size=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(size, CFG.num_channels, CFG.image_size,
                             CFG.image_size)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("layers", [(1, 8), (5, 7)])
def test_calibrate_shard_matches_jax(weights_file, layers):
    batches = _batches()
    if layers[0] > 1:   # a mid-model shard takes hidden states
        batches = [np.random.default_rng(i).normal(
            size=(4, CFG.num_patches + 1, CFG.hidden_size)).astype(
                np.float32) for i in range(2)]
    j_alphas, j_ws, j_stats = jcal.calibrate_shard(
        MODEL, weights_file, *layers, batches)
    t_alphas, t_ws, t_stats = tcal.calibrate_shard(
        MODEL, weights_file, *layers, batches, device="cpu")
    assert set(t_alphas) == set(j_alphas)
    if layers == (1, 8):
        assert set(t_alphas) == TAGS
    for tag in j_alphas:
        assert t_alphas[tag] == pytest.approx(j_alphas[tag], rel=1e-5)
        assert t_stats[tag].count == j_stats[tag].count
        assert t_stats[tag].amax == pytest.approx(j_stats[tag].amax,
                                                  rel=1e-5)
    assert sorted(t_ws) == sorted(j_ws)
    for key in j_ws:
        np.testing.assert_array_equal(t_ws[key], np.asarray(j_ws[key]))
    assert tlayers._QC_OBSERVER is None and jlayers._QC_OBSERVER is None


def test_weight_scale_keys_walk_blocks(weights_file):
    _, params, _ = treg.module_shard_factory(MODEL, weights_file, 1, 8,
                                             device="cpu")
    keys = set(tcal.weight_channel_scales(params))
    assert {"embeddings/patch", "final/head", "blocks/0/q",
            "blocks/1/mlp_down"} <= keys
    assert len(keys) == 2 + 6 * CFG.num_hidden_layers


def test_tag_stats_and_alphas_match_jax():
    rng = np.random.default_rng(1)
    arrays = [rng.laplace(size=500).astype(np.float32),
              np.abs(rng.normal(size=300)).astype(np.float32)]
    t_st, j_st = tcal.TagStats(), jcal.TagStats()
    for a in arrays:
        t_st.update(torch.from_numpy(a))
        j_st.update(a)
    assert t_st.count == j_st.count and t_st.amax == j_st.amax
    assert t_st.var == pytest.approx(j_st.var, rel=1e-12)
    assert t_st.second_moment == pytest.approx(j_st.second_moment,
                                               rel=1e-12)
    for bit in (4, 8):
        stats = {"attn.q": t_st, "mlp.down": t_st}
        assert tcal.compute_alphas(stats, bit) == pytest.approx(
            jcal.compute_alphas({"attn.q": j_st, "mlp.down": j_st}, bit),
            rel=1e-12)
    assert tcal.compute_alphas({"t": tcal.TagStats()})["t"] == 1.0


def test_collect_stats_requires_tags_and_restores_observer():
    with pytest.raises(RuntimeError, match="no tagged denses"):
        tcal.collect_activation_stats(lambda p, b: b, None,
                                      [torch.zeros(3)])
    assert tlayers._QC_OBSERVER is None


def test_sidecars_cross_load(tmp_path):
    alphas = {"attn.q": 1.25, "mlp.down": 0.5}
    wscales = {"blocks/0/q": np.array([0.1, 0.2], np.float32)}
    meta = {"model": MODEL, "bit": 8}
    t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tcal.write_sidecar(t_path, alphas, wscales, meta=meta)
    jcal.write_sidecar(j_path, alphas, wscales, meta=meta)
    for load in (jcal.load_sidecar, tcal.load_sidecar):
        for path in (t_path, j_path):
            side = load(path)
            assert side["alphas"] == pytest.approx(alphas)
            np.testing.assert_array_equal(
                side["weight_scales"]["blocks/0/q"], wscales["blocks/0/q"])
            assert side["meta"] == meta
    qc = tcal.quantize_compute_from_sidecar(
        j_path, skip_tags=("attn.out",), block_k=64, tunnel=True)
    assert qc == tlayers.QuantizeCompute(
        enabled=True, block_k=64, skip_tags=frozenset({"attn.out"}),
        clamp_alphas=tcal.load_sidecar(j_path)["alphas"], tunnel=True)
    assert tcal.sidecar_path("/x/m.npz") == jcal.sidecar_path("/x/m.npz")


def test_calibrate_entry_runs_on_cpu(tmp_path, capsys, weights_file):
    out = str(tmp_path / "tiny.int8scales.npz")
    assert tcal_entry.main(["-m", MODEL, "--model-file", weights_file,
                            "--batch", "4", "--batches", "1",
                            "--out", out, "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["bench"] == "calibrate" and rec["sidecar"] == out
    assert set(rec["alphas"]) == TAGS and rec["weight_scale_tensors"] > 0
    side = jcal.load_sidecar(out)             # the JAX package reads it
    assert side["meta"]["layers"] == [1, 8]
    assert side["alphas"] == pytest.approx(rec["alphas"], abs=1e-6)
    # the JAX tool, on the same weights and seed, finds the same alphas
    j_alphas, _, _ = jcal.calibrate_shard(
        MODEL, weights_file, 1, 8,
        [np.asarray(np.random.default_rng(0).normal(
            size=(4, CFG.num_channels, CFG.image_size, CFG.image_size)),
            np.float32)])
    assert rec["alphas"] == pytest.approx(
        {t: round(a, 6) for t, a in j_alphas.items()}, rel=1e-5, abs=2e-6)
