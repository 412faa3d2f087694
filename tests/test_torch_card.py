"""Port tests that need the card, and only those. They import neither
JAX nor the JAX package, so they run on the GPU host, where JAX is
absent, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py

On a host without a GPU each one skips with the reason.
"""
import pytest
import torch

from pipeedge_tpu_torch.comm import wire


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("bit", [0, 4, 8])
def test_v1_encoder_refuses_a_card_tensor(card, bit):
    """The v1 encoder would copy a card's stage output to the host and
    encode it there: it refuses, naming the device encoder, which takes
    the same tensor and whose frame decodes on the card."""
    t = torch.arange(24, dtype=torch.float32, device=card).reshape(2, 12)
    with pytest.raises(ValueError, match="wire_encode_device"):
        wire.wire_encode(t, bit)
    with pytest.raises(ValueError, match="wire_encode_device"):
        wire.wire_encode((t.cpu(), t), bit)
    frame = wire.wire_encode_device(t, bit).finalize()
    out = wire.wire_decode(frame, torch.float32, device=card)
    assert out.device == t.device and out.shape == t.shape
    # each item spans 11: a code step is 11 / (2**bit - 1)
    step = 0.0 if bit == 0 else 11.0 / (2 ** bit - 1)
    assert float((out - t).abs().max()) <= step / 2 + 1e-5
