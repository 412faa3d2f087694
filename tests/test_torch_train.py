"""The port's pipeline training against the JAX package.

`pipeedge_tpu_torch/parallel/train.py` differentiates the port's
`SpmdPipeline` with autograd on `[cpu] * n` (kernel 3's plain version,
which autograd differentiates). The oracle is the JAX package's own:
`jax.value_and_grad` of one unsharded forward (`make_shard_fn` over the
whole model, `tests/test_train.py _single_device_loss`), from one set of
seeded weights and inputs. The cases are those of `tests/test_train.py`:

- the tiny ViT (TINY4, 2 stages): the loss within rtol 1e-5 and every
  gradient leaf within rtol 2e-4 / atol 1e-5 of the oracle, the count of
  leaves compared asserted; the same under dp 2 x 2 stages, and with
  `remat`, whose gradients equal the plain ones to 1e-6;
- sequence parallelism: BERT over sp 2 with the ring core and GPT-2
  (causal) over sp 2 with Ulysses, against their oracles;
- Adam for 3 steps: the port's losses against `optax.adam` stepped on the
  oracle's gradients (rtol 1e-5);
- GPT-2 LM, Llama (GQA/RoPE) and the MoE GPT-2 learn under SGD;
- mixed precision keeps f32 masters and refuses bf16 ones, quantized
  edges are refused, save/restore is bit-continuous, all with the JAX
  package's words;
- one canonical copy: a pipeline whose positions hold distinct tensors
  steps to the same params as the shared-tensor build; `canonical` is
  read off the first dp cell (its own tensors, or under tp 2 the merged
  shards, whose gradients equal the oracle's).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pipeedge_tpu.models import ShardConfig as JShardConfig
from pipeedge_tpu.models import bert as jbert
from pipeedge_tpu.models import gpt2 as jgpt2
from pipeedge_tpu.models import vit as jvit
from pipeedge_tpu.models.layers import TransformerConfig as JCfg
from pipeedge_tpu.models.shard import make_shard_fn
from pipeedge_tpu.parallel import spmd as jspmd
from pipeedge_tpu.parallel import train as jtrain
from pipeedge_tpu_torch.models import ShardConfig as TShardConfig
from pipeedge_tpu_torch.models import bert as tbert
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import llama as tllama
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.models.convert import (params_from_jax,
                                               train_tree_from_jax)
from pipeedge_tpu_torch.models.layers import TransformerConfig as TCfg
from pipeedge_tpu_torch.parallel import spmd as tspmd
from pipeedge_tpu_torch.parallel import train as ttrain

RTOL, ATOL = 2e-4, 1e-5
TINY4 = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
             intermediate_size=64)
VIT = dict(model_type="vit", **TINY4, num_labels=5, image_size=16,
           patch_size=4)
PARTITION = [(1, 8), (9, 16)]
BERT = dict(model_type="bert", hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            layer_norm_eps=1e-12, vocab_size=60, max_position_embeddings=32,
            num_labels=2)
GPT2 = dict(model_type="gpt2", hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, layer_norm_eps=1e-5,
            vocab_size=50, max_position_embeddings=32)
HALVES = [(1, 4), (5, 8)]
MODULES = {"vit": (jvit, tvit), "bert": (jbert, tbert),
           "gpt2": (jgpt2, tgpt2)}


def _sc(pkg_cfg, l, r, total):
    return pkg_cfg(l, r, is_first=l == 1, is_last=r == total)


def _port_pipe(family, fields, weights, partition, remat=False,
               sp_kind="ring", **axes):
    cfg = TCfg(**fields)
    total = 4 * cfg.num_hidden_layers
    mod = MODULES[family][1]
    stages = [mod.load_params(cfg, _sc(TShardConfig, l, r, total), weights)
              for l, r in partition]
    mesh = tspmd.make_pipeline_mesh(len(partition), device="cpu", **axes)
    return tspmd.build_spmd_pipeline(mod.FAMILY, cfg, partition, stages,
                                     mesh, sp_kind=sp_kind, remat=remat)


class Oracle:
    """The JAX single-device loss and gradients of one model (jitted once
    per input shape), and the gradients laid out as the port's canonical
    tree for a partition."""

    def __init__(self, family, fields, weights):
        self.cfg = JCfg(**fields)
        total = 4 * self.cfg.num_hidden_layers
        sc = _sc(JShardConfig, 1, total, total)
        mod = MODULES[family][0]
        self.params = mod.load_params(self.cfg, sc, weights)
        fn = make_shard_fn(mod.FAMILY, self.cfg, sc)

        def loss(params, x, y):
            logits = jnp.stack([fn(params, u) for u in x])
            return jtrain.softmax_xent(logits, y)

        self.value_and_grad = jax.jit(jax.value_and_grad(loss))

    def __call__(self, x, y, params=None):
        return self.value_and_grad(self.params if params is None else params,
                                   jnp.asarray(x), jnp.asarray(y))

    @staticmethod
    def canonical(grads, partition):
        """{embed, final, blocks[s][j]} of a single-device gradient tree."""
        tree = params_from_jax(jax.device_get(grads))
        blocks, first = [], 0
        for l, r in partition:
            n = (r - l + 1) // 4
            blocks.append(tree["blocks"][first:first + n])
            first += n
        return {"embed": tree["embeddings"], "final": tree["final"],
                "blocks": blocks}


def _paths(tree, prefix=""):
    """(path, tensor) of a tree in `ttrain.tree_leaves` order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in _paths(tree[key], f"{prefix}.{key}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, item in enumerate(tree)
                for x in _paths(item, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _port_loss_and_grads(pipe, x, y, params=None):
    """The port's loss and the gradient of every canonical leaf, in
    `tree_leaves` order, with the step's own graph (`place` + forward)."""
    params = pipe.canonical if params is None else params
    leaves = ttrain.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = ttrain.softmax_xent(
        pipe.forward(pipe.place(params), torch.from_numpy(np.asarray(x))),
        torch.from_numpy(np.asarray(y)))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads]


def _check_grads(pipe, grads, want_tree, rtol=RTOL, atol=ATOL):
    """Every leaf, by path: the port's canonical tree against the
    oracle's; returns the count compared."""
    got_paths = [p for p, _ in _paths(pipe.canonical)]
    want = _paths(want_tree)
    assert got_paths == [p for p, _ in want]
    assert len(grads) == len(want)
    for g, (path, w) in zip(grads, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=path)
    return len(grads)


@pytest.fixture(scope="module")
def vit():
    weights = tvit.random_npz_weights(TCfg(**VIT), seed=0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 2, 3, 16, 16)).astype(np.float32)
    y = rng.integers(0, 5, size=(3, 2)).astype(np.int32)
    oracle = Oracle("vit", VIT, weights)
    val, grads = oracle(x, y)
    return dict(weights=weights, x=x, y=y, oracle=oracle, val=float(val),
                want=Oracle.canonical(grads, PARTITION))


def test_vit_pipeline_grads_match_single_device(vit):
    """d loss / d params through the port's 2-stage pipeline equals the
    JAX single-device gradient, leaf by leaf."""
    pipe = _port_pipe("vit", VIT, vit["weights"], PARTITION)
    loss, grads = _port_loss_and_grads(pipe, vit["x"], vit["y"])
    np.testing.assert_allclose(loss, vit["val"], rtol=1e-5, atol=1e-6)
    assert _check_grads(pipe, grads, vit["want"]) > 20


@pytest.mark.parametrize("dp,remat", [(2, False), (1, True), (2, True)])
def test_vit_dp_and_remat_grads(vit, dp, remat):
    """dp 2 x 2 stages and per-block remat give the oracle's gradients;
    remat's equal the plain pipeline's to 1e-6."""
    pipe = _port_pipe("vit", VIT, vit["weights"], PARTITION, remat=remat,
                      dp=dp)
    assert pipe.remat is remat and pipe.mesh.shape["dp"] == dp
    loss, grads = _port_loss_and_grads(pipe, vit["x"], vit["y"])
    np.testing.assert_allclose(loss, vit["val"], rtol=1e-5, atol=1e-6)
    assert _check_grads(pipe, grads, vit["want"]) > 20
    if remat:
        plain = _port_pipe("vit", VIT, vit["weights"], PARTITION, dp=dp)
        _, plain_grads = _port_loss_and_grads(plain, vit["x"], vit["y"])
        for a, b in zip(grads, plain_grads):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("family,sp_kind", [("bert", "ring"),
                                            ("gpt2", "ulysses")])
def test_sp_training_grads(family, sp_kind):
    """Long-context training: a (stage, sp) pipeline, its activations
    sequence-sharded over sp 2 (the ring core for BERT, Ulysses through
    kernel 3's plain version for the causal GPT-2), gives the oracle's
    gradients (JAX's test_sp_ring_attention_training_grads)."""
    fields = BERT if family == "bert" else GPT2
    weights = MODULES[family][1].random_npz_weights(TCfg(**fields), seed=1)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, fields["vocab_size"], size=(3, 2, 9)).astype(
        np.int32)
    if family == "bert":
        x, y = ids[..., :8], rng.integers(0, 2, size=(3, 2)).astype(np.int32)
    else:
        x, y = ids[..., :-1], ids[..., 1:]
    val, grads = Oracle(family, fields, weights)(x, y)
    pipe = _port_pipe(family, fields, weights, HALVES, sp=2,
                      sp_kind=sp_kind)
    assert pipe.mesh.shape == {"dp": 1, "stage": 2, "sp": 2}
    assert pipe.sp_kind == sp_kind
    loss, got = _port_loss_and_grads(pipe, x, y)
    np.testing.assert_allclose(loss, float(val), rtol=1e-5, atol=1e-6)
    assert _check_grads(pipe, got, Oracle.canonical(grads, HALVES)) > 20


def test_adam_trajectory_matches_optax(vit):
    """Three Adam steps: the port's losses against optax.adam stepped on
    the JAX oracle's gradients, and the final params leaf by leaf."""
    pipe = _port_pipe("vit", VIT, vit["weights"], PARTITION)
    x, y = torch.from_numpy(vit["x"]), torch.from_numpy(vit["y"])
    step, opt_state = ttrain.make_train_step(
        pipe, functools.partial(torch.optim.Adam, lr=1e-3), x)
    params, losses = pipe.canonical, []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))

    opt = optax.adam(1e-3)
    jparams = vit["oracle"].params
    jstate, want = opt.init(jparams), []
    for _ in range(3):
        val, grads = vit["oracle"](vit["x"], vit["y"], jparams)
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want.append(float(val))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = [p.detach().numpy() for _, p in _paths(params)]
    ref = _paths(Oracle.canonical(jparams, PARTITION))
    assert len(got) == len(ref)
    for g, (path, w) in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def test_train_tree_from_jax_is_the_canonical_tree(vit):
    """`models/convert.py train_tree_from_jax` maps the JAX pipeline's
    stage-stacked, zero-padded training tree to the port's canonical one
    (an uneven cut: 3 blocks, then 1)."""
    partition = [(1, 12), (13, 16)]
    cfg, total = JCfg(**VIT), 16
    jstages = [jvit.load_params(cfg, _sc(JShardConfig, l, r, total),
                                vit["weights"]) for l, r in partition]
    jpipe = jspmd.build_spmd_pipeline(
        jvit.FAMILY, cfg, partition, jstages,
        jspmd.make_pipeline_mesh(2, devices=jax.devices()[:2]))
    got = train_tree_from_jax(jax.device_get(jpipe.params))
    want = _port_pipe("vit", VIT, vit["weights"], partition).canonical
    assert [len(b) for b in got["blocks"]] == [3, 1]
    g, w = _paths(got), _paths(want)
    assert [p for p, _ in g] == [p for p, _ in w] and len(g) > 20
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)


def _lm_learns(family_mod, cfg, seed, make_weights=None):
    partition = HALVES
    stages = [family_mod.init_params(
        cfg, _sc(TShardConfig, l, r, 8), seed=0) for l, r in partition]
    pipe = tspmd.build_spmd_pipeline(
        family_mod.FAMILY, cfg, partition, stages,
        tspmd.make_pipeline_mesh(2, device="cpu"))
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(3, 2, 9)))
    inputs, labels = ids[..., :-1], ids[..., 1:]
    step, opt_state = ttrain.make_train_step(
        pipe, functools.partial(torch.optim.SGD, lr=0.1), inputs)
    params, losses = pipe.canonical, []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, inputs, labels)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    return losses


@pytest.mark.parametrize("family", ["gpt2", "llama", "moe"])
def test_lm_training_learns(family):
    """Causal-LM training through the pipeline ([M, B, S, V] logits,
    shifted ids as labels): GPT-2, Llama (RoPE, RMSNorm, SwiGLU, GQA) and
    the switch-MoE GPT-2 (the top-1 gate scales the expert output, so
    routing passes gradients) descend under SGD; seeds without gate ties
    (ROADMAP §C)."""
    common = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, layer_norm_eps=1e-5, vocab_size=50,
                  max_position_embeddings=32)
    if family == "llama":
        cfg, mod = TCfg(model_type="llama", num_kv_heads=2, **common), tllama
    elif family == "moe":
        cfg = TCfg(model_type="gpt2", n_experts=4, capacity_factor=4.0,
                   **common)
        mod = tgpt2
    else:
        cfg, mod = TCfg(model_type="gpt2", **common), tgpt2
    losses = _lm_learns(mod, cfg, seed={"gpt2": 2, "llama": 4,
                                         "moe": 6}[family])
    assert losses[-1] < losses[0] * 0.95, losses


def test_mixed_precision_keeps_f32_masters():
    """bf16 compute over f32 masters: the params stay f32 across updates,
    the loss descends and tracks the f32 run; bf16 params are refused in
    the JAX words."""
    cfg = TCfg(model_type="vit", hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64, num_labels=5,
               image_size=16, patch_size=4)
    rng = np.random.default_rng(11)
    inputs = torch.from_numpy(rng.normal(size=(3, 2, 3, 16, 16)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 5, size=(3, 2)))

    def build(dtype=torch.float32):
        stages = [tvit.init_params(cfg, _sc(TShardConfig, l, r, 8), seed=0,
                                   dtype=dtype) for l, r in HALVES]
        return tspmd.build_spmd_pipeline(
            tvit.FAMILY, cfg, HALVES, stages,
            tspmd.make_pipeline_mesh(2, device="cpu"))

    def run(mixed):
        pipe = build()
        step, opt_state = ttrain.make_train_step(
            pipe, functools.partial(torch.optim.SGD, lr=0.1), inputs,
            mixed_precision=mixed)
        params, losses = pipe.canonical, []
        for _ in range(5):
            params, opt_state, loss = step(params, opt_state, inputs,
                                           labels)
            losses.append(float(loss))
        return params, losses

    params_mp, losses_mp = run(True)
    _, losses_fp = run(False)
    assert np.isfinite(losses_mp).all() and losses_mp[-1] < losses_mp[0]
    assert all(p.dtype == torch.float32
               for p in ttrain.tree_leaves(params_mp))
    np.testing.assert_allclose(losses_mp, losses_fp, rtol=0.05)
    with pytest.raises(ValueError, match="float32 MASTER weights") as err:
        ttrain.make_train_step(build(torch.bfloat16),
                               functools.partial(torch.optim.SGD, lr=0.1),
                               inputs, mixed_precision=True)
    assert "(found ['bfloat16'])" in str(err.value)


def test_refusals_in_jax_words(vit):
    """Quantized edges and a wrong input shape are refused with the JAX
    package's messages."""
    x = torch.from_numpy(vit["x"])
    pipe = _port_pipe("vit", VIT, vit["weights"], PARTITION)
    pipe.stage_bits = (8, 0)
    with pytest.raises(ValueError, match="not differentiable"):
        ttrain.make_train_step(pipe, torch.optim.SGD, x)
    pipe.stage_bits = (0, 0)
    step, opt_state = ttrain.make_train_step(
        pipe, functools.partial(torch.optim.SGD, lr=0.1), x)
    with pytest.raises(ValueError, match=r"inputs shape \(2, 2, 3, 16, 16\) "
                       r"!= the compiled step's \(3, 2, 3, 16, 16\)"):
        step(pipe.canonical, opt_state, x[:2], torch.zeros(2, 2))


def test_train_state_checkpoint_resume(vit, tmp_path):
    """save/restore round-trip params, Adam's state and the step count,
    and training resumes bit for bit: one more step from the restored
    state gives the uninterrupted run's loss and params."""
    x, y = torch.from_numpy(vit["x"]), torch.from_numpy(vit["y"])
    opt = functools.partial(torch.optim.Adam, lr=1e-3)
    pipe = _port_pipe("vit", VIT, vit["weights"], PARTITION)
    step, opt_state = ttrain.make_train_step(pipe, opt, x)
    params = pipe.canonical
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, x, y)
    ttrain.save_train_state(str(tmp_path / "ckpt"), params, opt_state, 2)
    saved = [p.detach().clone() for p in ttrain.tree_leaves(params)]
    params_cont, _, loss_cont = step(params, opt_state, x, y)

    fresh = _port_pipe("vit", VIT, vit["weights"], PARTITION)
    fstep, like_opt = ttrain.make_train_step(fresh, opt, x)
    r_params, r_opt, r_step = ttrain.restore_train_state(
        str(tmp_path / "ckpt"), fresh.canonical, like_opt)
    assert r_step == 2
    for a, b in zip(ttrain.tree_leaves(r_params), saved):
        assert torch.equal(a, b)
    r_params2, _, r_loss = fstep(r_params, r_opt, x, y)
    assert float(r_loss) == float(loss_cont)
    for a, b in zip(ttrain.tree_leaves(r_params2),
                    ttrain.tree_leaves(params_cont)):
        assert torch.equal(a, b)


def test_one_canonical_copy(vit):
    """A pipeline whose dp positions hold distinct tensors (each placed
    leaf cloned, as on separate cards) steps to the same params as the
    shared-tensor build: the copies' gradients sum into the one canonical
    leaf the optimizer updates."""
    x, y = torch.from_numpy(vit["x"]), torch.from_numpy(vit["y"])
    opt = functools.partial(torch.optim.SGD, lr=0.1)
    shared = _port_pipe("vit", VIT, vit["weights"], PARTITION, dp=2)
    apart = _port_pipe("vit", VIT, vit["weights"], PARTITION, dp=2)
    place = apart.place
    apart.place = lambda tree: ttrain.tree_map(lambda t: t.clone(),
                                               place(tree))
    for tree, distinct in ((apart.place(apart.canonical), True),
                           (shared.params, False)):
        cell0, cell1 = (ttrain.tree_leaves(tree["blocks"][1][d])
                        for d in (0, 1))
        assert all((a is not b) == distinct for a, b in zip(cell0, cell1))
    got = []
    for pipe in (shared, apart):
        step, opt_state = ttrain.make_train_step(pipe, opt, x)
        params, _, _ = step(pipe.canonical, opt_state, x, y)
        got.append(ttrain.tree_leaves(params))
    moved = 0
    for a, b, w in zip(*got, ttrain.tree_leaves(
            _port_pipe("vit", VIT, vit["weights"], PARTITION).canonical)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
        moved += not torch.equal(a.detach(), w)
    assert moved > 20


@pytest.mark.parametrize("axes", [{}, {"dp": 2}, {"tp": 2}],
                         ids=["single", "dp2", "tp2"])
def test_canonical_is_read_off_the_positions(vit, axes):
    """A pipeline holds no parameter tree beside `params`: `canonical` is
    read off the first dp cell. Without tp its leaves are that cell's own
    tensors (no copy); under tp 2 the shards merge back into the
    unsharded leaves, `place` splits them into `params` again, and the
    gradients through the tp blocks are the oracle's."""
    pipe = _port_pipe("vit", VIT, vit["weights"], PARTITION, **axes)
    assert "canonical" not in vars(pipe)
    tree = pipe.canonical
    leaves = ttrain.tree_leaves
    if "tp" not in axes:
        cell0 = [[shards[0] for shards in stage[0]]
                 for stage in pipe.params["blocks"]]
        assert tree["embed"] is pipe.params["embed"][0]
        assert tree["final"] is pipe.params["final"][0]
        pairs = list(zip(leaves(tree["blocks"]), leaves(cell0)))
        assert len(pairs) > 20 and all(a is b for a, b in pairs)
        return
    whole = _paths(_port_pipe("vit", VIT, vit["weights"],
                              PARTITION).canonical)
    got = _paths(tree)
    assert [p for p, _ in got] == [p for p, _ in whole] and len(got) > 20
    for (path, a), (_, b) in zip(got, whole):
        assert torch.equal(a, b), path
    placed = leaves(pipe.place(tree))
    assert len(placed) == len(leaves(pipe.params))
    for a, b in zip(placed, leaves(pipe.params)):
        assert torch.equal(a, b)
    loss, grads = _port_loss_and_grads(pipe, vit["x"], vit["y"])
    np.testing.assert_allclose(loss, vit["val"], rtol=1e-5, atol=1e-6)
    assert _check_grads(pipe, grads, vit["want"]) > 20
