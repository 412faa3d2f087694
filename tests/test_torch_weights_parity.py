"""The port's shards against the committed HF-torch parity anchors.

The counterpart of `tests/test_weights_parity.py` for `pipeedge_tpu_torch`:
the weights are regenerated by the same seeded `--random` recipe
(`save_model_weights.py`, whose HF init `tools/make_parity_fixture.py`
froze into `tests/fixtures/<slug>_random_torch_logits.npz` with a weight
probe), loaded through the port's `module_shard_factory` on the CPU and
run as one shard; the logits must reproduce HF torch's recorded f32
logits within rtol = atol = 2e-4, the JAX package's bound for the same
anchors. The full-size families are `slow`, as the JAX file's are; the
tiny Llama is cheap and runs in tier 1.
"""
import numpy as np
import pytest
import torch

from pipeedge_tpu_torch.models import registry

FULL_SIZE = ["google/vit-base-patch16-224",
             "facebook/deit-base-distilled-patch16-224",
             "textattack/bert-base-uncased-CoLA", "gpt2"]


@pytest.mark.parametrize("model_name", [
    *[pytest.param(name, marks=pytest.mark.slow) for name in FULL_SIZE],
    "pipeedge/test-tiny-llama",
])
def test_port_parity_vs_committed_torch_logits(model_name, tmp_path,
                                               monkeypatch):
    import save_model_weights
    from tools.make_parity_fixture import (SPECS, build_torch_model,
                                           fixture_input, fixture_path,
                                           weight_probe)

    spec = SPECS[model_name]
    fx = np.load(fixture_path(model_name))
    monkeypatch.chdir(tmp_path)

    # the probe tells an HF init-recipe drift from a port fault
    model, cfg = build_torch_model(model_name)
    np.testing.assert_allclose(
        weight_probe(model, model_name), fx["weight_probe"], rtol=0, atol=0,
        err_msg=f"HF --random init recipe drifted for {model_name}")
    del model

    save_model_weights.save_weights(model_name, "w.npz", random_init=True)
    layers = registry.get_model_layers(model_name)
    fn, params, _ = registry.module_shard_factory(model_name, "w.npz", 1,
                                                  layers, device="cpu")
    x = torch.from_numpy(fixture_input(cfg, model_name))
    got = fn(params, x).numpy()
    tail = spec.get("tail_positions")
    if tail:
        got = got[:, -tail:]
    np.testing.assert_allclose(got, fx["logits"], rtol=2e-4, atol=2e-4)
