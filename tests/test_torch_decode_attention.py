"""The port's int8 decode attention (plain version, the CPU path of its
kernel wrapper) and its routing gate, against the JAX package.

- `decode_attention_reference` against the JAX `int8_decode_attention` in
  interpret mode (variants 1 and 2) and against the JAX dequantize-then-
  attend route (`_dequantize_rows` + `_attend`), on the same seeded
  inputs. f32: rtol = atol = 2e-5, the JAX test's bound
  (tests/test_decode_attention.py). bf16: rtol = atol = 1e-2; both sides
  round K, V, the probabilities and the output to bf16 (2^-8 relative),
  at different points (per-block running max in the TPU kernel, the
  global max here, normalized probabilities in `_attend`), so outputs may
  sit a bf16 ulp or two apart.
- `_quantize_rows` codes, scales and shifts identical to JAX's.
- The gate's scope and the opt-in's precedence and binding.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu.ops import decode_attention as jda
from pipeedge_tpu.parallel import decode as jdec
from pipeedge_tpu_torch.models import layers as tlayers
from pipeedge_tpu_torch.models import registry as treg
from pipeedge_tpu_torch.ops import _build
from pipeedge_tpu_torch.ops import decode_attention as tda
from pipeedge_tpu_torch.parallel import decode as tdec

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
B, T, H, D = 2, 24, 4, 16
MODEL = "pipeedge/test-tiny-gpt2"


def _inputs(seed):
    """Seeded rows quantized by the JAX package, as numpy arrays."""
    rng = np.random.default_rng(seed)
    k_rows = rng.normal(size=(B, T, H, D)).astype(np.float32)
    v_rows = rng.normal(size=(B, T, H, D)).astype(np.float32)
    q, k_new, v_new = (rng.normal(size=(B, 1, H, D)).astype(np.float32)
                       for _ in range(3))
    kq, ks, kz = (np.array(a) for a in jdec._quantize_rows(
        jnp.asarray(k_rows)))
    vq, vs, vz = (np.array(a) for a in jdec._quantize_rows(
        jnp.asarray(v_rows)))
    return dict(q=q, k_q=kq, k_scale=ks, k_shift=kz, v_q=vq, v_scale=vs,
                v_shift=vz, k_new=k_new, v_new=v_new)


_ORDER = ("q", "k_q", "k_scale", "k_shift", "v_q", "v_scale", "v_shift",
          "k_new", "v_new")
_ACT = ("q", "k_new", "v_new")


def _jax_args(x, dtype=jnp.float32):
    return [jnp.asarray(x[n], dtype) if n in _ACT else jnp.asarray(x[n])
            for n in _ORDER]


def _torch_args(x, dtype=torch.float32):
    return [torch.from_numpy(x[n]).to(dtype) if n in _ACT
            else torch.from_numpy(x[n]) for n in _ORDER]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("pos", [0, 13, T - 1])
@pytest.mark.parametrize("variant", [1, 2])
def test_reference_matches_pallas_interpret(variant, pos):
    x = _inputs(seed=pos)
    want = jda.int8_decode_attention(*_jax_args(x), pos, interpret=True,
                                     variant=variant)
    got = tda.int8_decode_attention(*_torch_args(x), pos, variant=variant)
    assert tuple(got.shape) == (B, 1, H * D) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def _jax_attend_route(x, pos, dtype):
    """The JAX dequantize-then-attend route on the same window."""
    k = jdec._dequantize_rows(jnp.asarray(x["k_q"]), x["k_scale"],
                              x["k_shift"], dtype)
    v = jdec._dequantize_rows(jnp.asarray(x["v_q"]), x["v_scale"],
                              x["v_shift"], dtype)
    k = k.at[:, pos:pos + 1].set(jnp.asarray(x["k_new"], dtype))
    v = v.at[:, pos:pos + 1].set(jnp.asarray(x["v_new"], dtype))
    keep = (jnp.arange(T) <= pos)[None, :]
    return jdec._attend(jnp.asarray(x["q"], dtype), k, v, keep,
                        jreg.get_model_config(MODEL))


@pytest.mark.parametrize("pos", [0, 9, T - 1])
def test_reference_matches_jax_attend_route_f32(pos):
    x = _inputs(seed=40 + pos)
    got = tda.decode_attention_reference(*_torch_args(x), pos)
    np.testing.assert_allclose(_np(got), _np(_jax_attend_route(
        x, pos, jnp.float32)), **F32_TOL)


@pytest.mark.parametrize("pos", [0, 9, T - 1])
def test_reference_matches_jax_bf16(pos):
    x = _inputs(seed=60 + pos)
    got = tda.int8_decode_attention(*_torch_args(x, torch.bfloat16), pos)
    assert got.dtype == torch.bfloat16
    want_kernel = jda.int8_decode_attention(
        *_jax_args(x, jnp.bfloat16), pos, interpret=True, variant=1)
    want_route = _jax_attend_route(x, pos, jnp.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want_kernel), **BF16_TOL)
    np.testing.assert_allclose(_np(got), _np(want_route), **BF16_TOL)


def test_strided_window_of_a_stage_cache():
    """The route passes `cache[:, :w]` of a [L, B, T, H, Dh] stage cache: a
    view with batch stride T*H*Dh. The reference reads it in place and
    equals the JAX kernel on the same window."""
    x = _inputs(seed=7)
    w, pos = 16, 11
    cache = {name: torch.zeros((3, B, T + 8) + x[name].shape[2:],
                               dtype=torch.from_numpy(x[name]).dtype)
             for name in ("k_q", "k_scale", "k_shift", "v_q", "v_scale",
                          "v_shift")}
    for name, c in cache.items():
        c[1, :, :T] = torch.from_numpy(x[name])
    views = {name: c[1][:, :w] for name, c in cache.items()}
    assert not views["k_q"].is_contiguous()
    args = [torch.from_numpy(x[n]) if n in _ACT else views[n]
            for n in _ORDER]
    got = tda.int8_decode_attention(*args, pos)
    window = {n: (x[n] if n in _ACT else x[n][:, :w]) for n in _ORDER}
    want = jda.int8_decode_attention(*_jax_args(window), pos,
                                     interpret=True, variant=1)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # rows past pos are not read: garbage there changes nothing
    for name in ("k_q", "v_q"):
        views[name][:, pos + 1:] = 127
    for name in ("k_scale", "v_scale"):
        views[name][:, pos + 1:] = float("nan")
    args = [torch.from_numpy(x[n]) if n in _ACT else views[n]
            for n in _ORDER]
    assert torch.equal(tda.int8_decode_attention(*args, pos), got)


def test_cpu_path_counts_no_launch_and_rejects_bad_inputs():
    x = _inputs(seed=3)
    args = _torch_args(x)
    before = dict(_build.launch_counts)
    tda.int8_decode_attention(*args, 5)
    assert _build.launch_counts == before
    with pytest.raises(ValueError, match="pos"):
        tda.int8_decode_attention(*args, T)
    with pytest.raises(ValueError, match="variant"):
        tda.int8_decode_attention(*args, 5, variant=3)
    bad = list(args)
    bad[1] = args[1].float()                       # k_q not int8
    with pytest.raises(ValueError):
        tda.int8_decode_attention(*bad, 5)
    bad = list(args)
    bad[7] = args[7].to(torch.bfloat16)            # k_new dtype != q's
    with pytest.raises(ValueError):
        tda.int8_decode_attention(*bad, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_identical_to_jax(dtype):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(3, 5, H, D)) * 4).astype(np.float32)
    x[1, 2, 3] = 0.25                              # a zero-range row
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for got, want in zip(tdec._quantize_rows(tx), jdec._quantize_rows(jx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tdec._dequantize_rows(*tdec._quantize_rows(tx), torch.float32)
    want = jdec._dequantize_rows(*jdec._quantize_rows(jx), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gate_scope():
    cfg = treg.get_model_config(MODEL)
    cache8 = {"k": torch.zeros((1, 4, 4, 8), dtype=torch.int8),
              "k_scale": None}
    gate = tdec._use_int8_decode_kernel
    # span / fp cache / GQA / window never route, even when opted in
    assert gate(cache8, 2, cfg, 1) is None
    assert gate({"k": None}, 1, cfg, 1) is None
    gqa = dataclasses.replace(cfg, num_kv_heads=2)
    assert gqa.kv_heads == 2 and gate(cache8, 1, gqa, 1) is None
    assert gate(cache8, 1, dataclasses.replace(cfg, sliding_window=4),
                1) is None
    # off: the dequantize route; on: the kernel, variant passed through;
    # 'auto' (3) routes every eligible step (no width cap on the card)
    assert gate(cache8, 1, cfg, 0) is None
    assert gate(cache8, 1, cfg, 1) == 1
    assert gate(cache8, 1, cfg, 2) == 2
    assert gate(cache8, 1, cfg, 3) == 2


@pytest.mark.parametrize("value", [None, "", "0", "false", "no", "off", "1",
                                   "yes", "2", "auto", "AUTO"])
def test_env_resolution_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("PIPEEDGE_INT8_DECODE_ATTEND", raising=False)
    else:
        monkeypatch.setenv("PIPEEDGE_INT8_DECODE_ATTEND", value)
    assert tdec._int8_kernel_env() == jdec._int8_kernel_env()
    for override in (None, 0, 1, 2, "auto", "off", "2"):
        assert tdec._resolve_int8_optin(override) == \
            jdec._resolve_int8_optin(override)


def test_optin_precedence_arg_env_config(monkeypatch):
    monkeypatch.delenv("PIPEEDGE_INT8_DECODE_ATTEND", raising=False)
    monkeypatch.delenv("PIPEEDGE_QUANTIZE_COMPUTE", raising=False)
    tlayers.set_quantize_compute(None)
    try:
        assert tdec._resolve_int8_optin() == 0          # default: off
        tlayers.set_quantize_compute(True)
        assert tdec._resolve_int8_optin() == 3          # config promotes
        monkeypatch.setenv("PIPEEDGE_INT8_DECODE_ATTEND", "0")
        assert tdec._resolve_int8_optin() == 0          # env beats config
        monkeypatch.setenv("PIPEEDGE_INT8_DECODE_ATTEND", "1")
        assert tdec._resolve_int8_optin() == 1
        assert tdec._resolve_int8_optin("2") == 2       # arg beats env
        assert tdec._resolve_int8_optin(0) == 0
    finally:
        tlayers.set_quantize_compute(None)


def test_optin_bound_at_construction(monkeypatch):
    monkeypatch.setenv("PIPEEDGE_INT8_DECODE_ATTEND", "1")
    entry = treg.get_model_entry(MODEL)
    _, params, _ = treg.module_shard_factory(MODEL, None, 1, 8,
                                             device="cpu")
    pipe = tdec.DecodePipeline(entry.family.FAMILY, entry.config, [(1, 8)],
                               [params], max_len=32, device="cpu",
                               cache_bits=8)
    assert pipe.int8_decode_optin == 1
    monkeypatch.setenv("PIPEEDGE_INT8_DECODE_ATTEND", "0")
    assert pipe.int8_decode_optin == 1                 # captured
    routed = []
    real = tda.int8_decode_attention

    def spy(*args, **kw):
        routed.append(kw.get("variant"))
        return real(*args, **kw)

    monkeypatch.setattr(tda, "int8_decode_attention", spy)
    pipe.generate(np.zeros((1, 3), np.int64), 3)
    assert routed == [1] * 2 * entry.config.num_hidden_layers
    monkeypatch.delenv("PIPEEDGE_INT8_DECODE_ATTEND")
    pipe2 = tdec.DecodePipeline(entry.family.FAMILY, entry.config, [(1, 8)],
                                [params], max_len=32, device="cpu",
                                cache_bits=8)
    assert pipe2.int8_decode_optin == 0


# --- kernel 5's split over rows, merged by the log-sum-exp rule ------------

T_SPLIT = 256
_SPLIT_WANT = {}


def _split_inputs():
    """Seeded inputs with a 256-row window (pos up to 255)."""
    rng = np.random.default_rng(123)
    k_rows = rng.normal(size=(B, T_SPLIT, H, D)).astype(np.float32)
    v_rows = rng.normal(size=(B, T_SPLIT, H, D)).astype(np.float32)
    q, k_new, v_new = (rng.normal(size=(B, 1, H, D)).astype(np.float32)
                       for _ in range(3))
    kq, ks, kz = (np.array(a) for a in jdec._quantize_rows(
        jnp.asarray(k_rows)))
    vq, vs, vz = (np.array(a) for a in jdec._quantize_rows(
        jnp.asarray(v_rows)))
    return dict(q=q, k_q=kq, k_scale=ks, k_shift=kz, v_q=vq, v_scale=vs,
                v_shift=vz, k_new=k_new, v_new=v_new)


def _split_merge(x, pos, splits):
    """Kernel 5's order in plain PyTorch: one (max, sum, acc) partial per
    row range of `split_ranges` (an empty range gives (-1e30, 0, 0)),
    merged by the log-sum-exp rule as the cluster's rank 0 merges them."""
    t = {n: torch.from_numpy(x[n]) for n in _ORDER}
    n = pos + 1

    def rows(codes, scale, shift, new):
        r = ((codes[:, :n].double() + 128.0) * scale[:, :n, :, None].double()
             + shift[:, :n, :, None].double())
        r[:, pos] = new[:, 0].double()
        return r                                            # [B, n, H, D]

    k = rows(t["k_q"], t["k_scale"], t["k_shift"], t["k_new"])
    v = rows(t["v_q"], t["v_scale"], t["v_shift"], t["v_new"])
    scores = torch.einsum("bhd,bnhd->bhn", t["q"][:, 0].double(), k) \
        / np.sqrt(D)
    parts = []
    for r0, r1 in tda.split_ranges(pos, splits):
        if r0 == r1:
            parts.append((torch.full((B, H), -1e30, dtype=torch.float64),
                          torch.zeros((B, H), dtype=torch.float64),
                          torch.zeros((B, H, D), dtype=torch.float64)))
            continue
        s = scores[..., r0:r1]
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("bhn,bnhd->bhd", p, v[:, r0:r1])))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    den = sum(l * torch.exp(m - mx) for m, l, _ in parts)
    num = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
    return (num / den[..., None]).float().reshape(B, 1, H * D)


@pytest.mark.parametrize("pos", [0, 7, 200, 255])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", [1, 2])
def test_split_merge_matches_pallas_interpret(variant, splits, pos):
    x = _split_inputs()
    if (variant, pos) not in _SPLIT_WANT:
        _SPLIT_WANT[variant, pos] = _np(jda.int8_decode_attention(
            *_jax_args(x), pos, interpret=True, variant=variant))
    got = _split_merge(x, pos, splits)
    np.testing.assert_allclose(_np(got), _SPLIT_WANT[variant, pos],
                               rtol=2e-5, atol=2e-5)


def test_split_count_covers_rows_once():
    """For every pos of a 1024-row cache the wrapper's split count is a
    cluster size the launch takes (1..8), and its ranges cover rows
    [0, pos] exactly once, in order, none of them empty."""
    for pos in range(1024):
        splits = tda.split_count(pos)
        assert 1 <= splits <= 8
        ranges = tda.split_ranges(pos, splits)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == pos + 1
        for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
            assert a1 == b0
        assert all(r1 > r0 for r0, r1 in ranges)


# --- which windows the kernel takes, and the route gate that asks it -------

def _meta_window(b, w, h, d, row_stride=None, offset=0):
    """A [B, W, H, Dh] int8 window on the meta device: shapes, strides and
    addresses without storage, what the CUDA kernel's checks read."""
    row = h * d if row_stride is None else row_stride
    base = torch.empty((b * w * row + offset + 64,), dtype=torch.int8,
                       device="meta")
    return base.as_strided((b, w, h, d), (w * row, row, d, 1), offset)


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_window_refusal_takes_registry_head_dims(d):
    win = _meta_window(16, 64, 4, d)
    assert tda.window_refusal(win, win) is None


@pytest.mark.parametrize("case", ["dh12", "dh256", "base", "row_stride",
                                  "heads"])
def test_window_refusal_names_what_the_kernel_refuses(case):
    win = {"dh12": lambda: _meta_window(2, 8, 4, 12),
           "dh256": lambda: _meta_window(2, 8, 1, 256),
           "base": lambda: _meta_window(2, 8, 4, 16, offset=8),
           "row_stride": lambda: _meta_window(2, 8, 1, 16, row_stride=24),
           "heads": lambda: _meta_window(1, 1, 65536, 8)}[case]()
    assert tda.window_refusal(win, win) is not None


def test_window_refusal_takes_any_batch():
    """The batch cells go to the kernel in launches of at most 65535."""
    win = _meta_window(65537, 16, 1, 16)
    assert tda.window_refusal(win, win) is None
    chunks = _build.launch_chunks(65537)
    assert chunks == [(0, 65535), (65535, 65537)]


@pytest.mark.parametrize("n", [0, 1, 65534, 65535, 65536, 3 * 65535 + 7])
def test_launch_chunks_cover_items_once(n):
    chunks = _build.launch_chunks(n)
    assert all(0 < e - s <= _build.MAX_GRID_YZ for s, e in chunks)
    assert [i for s, e in chunks for i in range(s, e)] == list(range(n))


def test_gate_refuses_off_the_cpu_what_the_kernel_refuses():
    """On a device other than the CPU the gate asks `window_refusal`
    before the step writes its row: a window the kernel takes routes to
    it, one it refuses stays on the dequantize route. On the CPU, where
    the plain version takes every window, the same cache routes."""
    cfg = treg.get_model_config(MODEL)
    gate = tdec._use_int8_decode_kernel

    def cache(k, v=None):
        return {"k": k, "v": k if v is None else v, "k_scale": None}

    tiny = _meta_window(4, 64, cfg.num_attention_heads, cfg.head_dim)
    assert cfg.head_dim == 8 and gate(cache(tiny), 1, cfg, 1) == 1
    assert gate(cache(tiny), 1, cfg, 3) == 2
    for bad in (_meta_window(4, 64, 4, 12),
                _meta_window(4, 64, 4, 8, offset=8),
                _meta_window(4, 64, 3, 8, row_stride=24)):
        assert gate(cache(bad), 1, cfg, 1) is None
    assert gate(cache(tiny, _meta_window(4, 64, 4, 8, offset=8)), 1, cfg,
                1) is None
    cpu_odd = torch.zeros((4, 64, 4, 12), dtype=torch.int8)
    assert gate(cache(cpu_odd), 1, cfg, 1) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_interpret_head_dim_8(dtype):
    """The tiny GPT-2's head dim: the plain version (what the kernel is
    held to on the card) against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(8)
    b, t, h, d, pos = 3, 20, 4, 8, 17
    rows = {n: rng.normal(size=(b, t, h, d)).astype(np.float32)
            for n in ("k", "v")}
    x = {n: rng.normal(size=(b, 1, h, d)).astype(np.float32)
         for n in _ACT}
    for n in ("k", "v"):
        x[f"{n}_q"], x[f"{n}_scale"], x[f"{n}_shift"] = (
            np.array(a) for a in jdec._quantize_rows(jnp.asarray(rows[n])))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jda.int8_decode_attention(*_jax_args(x, jdt), pos, interpret=True,
                                     variant=1)
    got = tda.int8_decode_attention(*_torch_args(x, tdt), pos)
    assert tuple(got.shape) == (b, 1, h * d)
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
