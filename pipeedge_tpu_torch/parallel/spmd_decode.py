"""SPMD wave decoding: R = n_stages request slots walked as one wave.

Port of `pipeedge_tpu/parallel/spmd_decode.py`. The JAX package compiles
the whole wave schedule into two `shard_map` programs over a `('stage',)`
mesh, a prefill wave and a decode wave, so a generation makes no host
round-trip between its first and its last token. Here one process drives
the same schedule over a `PipelineMesh` (dp 1), as `parallel/spmd.py`
drives the forward pipeline:

- **The waves.** The prefill wave has R + K - 1 ticks: at tick t stage i
  prefills slot t - i when 0 <= t - i < R. The decode wave has
  (N - 1) R + K - 1 ticks: stage i serves slot (t - i) mod R at wave
  floor((t - i) / R) + 1, position S_p + wave - 1, when t - i >= 0 and
  the wave is at most N - 1. The span wave (a prefix-seeded prompt pass,
  the speculative verify) walks the prefill wave's ticks with [B, K]
  spans at a cache offset. The controller runs only the valid (stage,
  tick) pairs, R x K stage-steps a wave, where the JAX scan runs every
  device every tick and gates the fill and drain ticks' cache writes;
  within a tick the stages run last to first, so each edge holds one
  payload, as the scan's carry does.
- **One block step.** Each stage runs `decode.make_stage_fns`' functions:
  the family's `cached_block_step` (Llama) or `decode._block_step`, its
  `decode_embed`/`span_embed` or the GPT-2 ones, and the host pipeline's
  bucketed attend windows, so the wave and `DecodePipeline` share one
  attention and cache semantics.
- **Caches.** Each stage holds one cache of R x B rows (`decode.
  init_cache`); slot r works on rows [r B, (r + 1) B) through a view,
  written in place. Only valid pairs run, so no write needs the JAX
  validity gate.
- **Edges.** The [B, S_p, D] prefill and span hops go through the SPMD
  pipeline's codec pair (`spmd.encode_edge`/`decode_edge`: kernels 1 and
  2 at 4 and 8 bits, the plain codec at 2, 6 and 16, the tensor at 0),
  without the Banner clamp, as in JAX; the [B, 1, D] decode hops stay
  raw. A hop is `PipelineMesh.hop`, the tensor itself on one card.
- **Tokens stay on the device.** The last stage writes each picked token
  into `cur_tok` [R, B] on stage 0's device (one hop across cards, the
  tensor itself on one), and stage 0 embeds from it: the counterpart of
  the JAX `psum` broadcast. Nothing in a wave reads the card back;
  `generate` returns the ids on the last stage's device.
- **Sampling.** Slot r draws from its own `torch.Generator` on the last
  stage's device, seeded `seeds[r]` (default r), once per picked token,
  so its stream equals `DecodePipeline.generate(ids[r], ..., seed=
  seeds[r])`: the JAX contract carried to torch's generator (the two
  packages' sampled streams differ; greedy is the path held to JAX).

Kernel launches: kernels 1 and 2 once per prefill- or span-wave hop at 4
and 8 bits, R x (K - 1) each a wave; none in the decode wave. The decode
attends through `decode._attend`, as JAX's `_block_step` does, so kernel
3 is not on this path; fp caches only (no kernel 5).
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models import ShardConfig
from ..models.layers import TransformerConfig
from ..models.shard import params_to
from . import decode as dec
from .mesh import PipelineMesh
from .spmd import decode_edge, encode_edge, make_pipeline_mesh, \
    partition_to_blocks

logger = logging.getLogger(__name__)

EDGE_BITS = (0, 2, 4, 6, 8, 16)


class SpmdDecodePipeline:
    """Wave-scheduled decoding over a `('stage',)` mesh (module docstring).

    `mesh` is a `PipelineMesh` of dp 1 whose stage count is the
    partition's, a list of one device per stage, or None: `devices_for(K,
    device)`, stage i on `cuda:i % device_count()` (every stage on `cpu`
    for `device="cpu"`). `generate(ids, new_tokens)` takes ids [R, B,
    S_p], R = n_stages request slots decoded concurrently, and returns
    [R, B, S_p + N]."""

    def __init__(self, family, cfg: TransformerConfig,
                 partition: Sequence[Tuple[int, int]],
                 stage_params: Sequence[Dict], mesh=None, max_len: int = 1024,
                 dtype=torch.float32, edge_bits: int = 0,
                 attend_floor: int = 64, device="cuda"):
        total = 4 * cfg.num_hidden_layers
        dec.validate_partition(partition, total)
        dec.validate_capacity(cfg, max_len)
        partition_to_blocks(partition)   # rejects mid-block cuts
        n_stages = len(partition)
        if mesh is None:
            mesh = make_pipeline_mesh(n_stages, device=device)
        elif not isinstance(mesh, PipelineMesh):
            mesh = PipelineMesh(list(mesh), 1, len(mesh))
        if mesh.dp != 1 or mesh.inner != 1:
            raise ValueError(f"SPMD wave decode runs over a ('stage',) "
                             f"mesh; got {mesh.shape}")
        if mesh.shape["stage"] != n_stages:
            raise ValueError(f"mesh 'stage' axis {mesh.shape['stage']} != "
                             f"{n_stages} pipeline stages")
        if cfg.n_experts:
            raise NotImplementedError(
                "SPMD wave decode covers dense families; MoE decodes via "
                "DecodePipeline(ep_mesh/tp_ep_mesh)")
        if edge_bits not in EDGE_BITS:
            raise ValueError(f"edge_bits must be one of 0/2/4/6/8/16, got "
                             f"{edge_bits}")
        if attend_floor < 1:
            raise ValueError(f"attend_floor must be >= 1, got {attend_floor}")
        self.family, self.cfg, self.mesh = family, cfg, mesh
        self.n_stages, self.max_len, self.dtype = n_stages, max_len, dtype
        self.edge_bits, self.attend_floor = edge_bits, attend_floor
        self.stages: List[Dict] = []
        for i, ((l, r), p) in enumerate(zip(partition, stage_params)):
            n_blocks = len(dec.stage_blocks(p))
            sc = ShardConfig(l, r, is_first=l == 1, is_last=r == total)
            prefill, decode = dec.make_stage_fns(family, cfg, sc,
                                                 int8_optin=0)
            device = mesh.cell(0, i).devices[0]
            self.stages.append(dict(
                n_blocks=n_blocks, device=device, prefill=prefill,
                decode=decode, params=params_to(p, device=device)))
        if "embeddings" not in stage_params[0] \
                or "final" not in stage_params[-1]:
            raise ValueError("stage 0 must carry 'embeddings' and the last "
                             "stage 'final'")
        self.first = self.stages[0]["device"]
        self.last = self.stages[-1]["device"]
        # the walk of the last generate call (or precompute_prefix)
        self.stats = {"ticks": 0, "stage_steps": 0}
        logger.info("SPMD wave decode: %d stage(s) on %s, edge bits %d",
                    n_stages, [str(st["device"]) for st in self.stages],
                    edge_bits)

    # -- the per-tick pieces -----------------------------------------------

    def _read_len(self, pos: int, span: int = 1) -> int:
        """The attend window of a step whose last row sits at pos + span
        - 1: `DecodePipeline._read_len`'s bucket."""
        return dec.attend_bucket(pos + span, self.max_len, self.attend_floor)

    def _fresh_caches(self, rows: int) -> List[dec.Cache]:
        return [dec.init_cache(self.cfg, st["n_blocks"], rows, self.max_len,
                               self.dtype, device=st["device"])
                for st in self.stages]

    @staticmethod
    def _slot(cache: dec.Cache, r: int, batch: int) -> dec.Cache:
        """Slot r's rows of a stage cache, as views written in place."""
        return {k: c[:, r * batch:(r + 1) * batch] for k, c in cache.items()}

    def _step(self, s: int, data, cache: dec.Cache, pos: Optional[int],
              span: int = 1):
        """One stage-step: a prefill (`pos` None) or a decode/span step at
        `pos` in the host pipeline's attend window."""
        st = self.stages[s]
        self.stats["stage_steps"] += 1
        if pos is None:
            return st["prefill"](st["params"], data, cache)[0]
        return st["decode"](st["params"], data, cache, pos,
                            read_len=self._read_len(pos, span))[0]

    def _fill_wave(self, inputs: Sequence[torch.Tensor], caches, batch: int,
                   finish, pos: Optional[int] = None) -> None:
        """The prefill wave (`pos` None) or the span wave at cache offset
        `pos` over len(inputs) slots: at tick t stage i runs slot t - i.
        Stage 0 takes `inputs[r]` (ids [B, S] on its device); the edges
        carry the codec's payload; `finish(r, logits)` takes the last
        stage's output."""
        n, slots = self.n_stages, len(inputs)
        span = inputs[0].shape[1]
        edges: Dict[int, object] = {}
        for t in range(slots + n - 1):
            for s in reversed(range(n)):
                r = t - s
                if not 0 <= r < slots:
                    continue
                data = inputs[r] if s == 0 else decode_edge(edges.pop(s),
                                                            self.dtype)
                out = self._step(s, data, self._slot(caches[s], r, batch),
                                 pos, span)
                if s == n - 1:
                    finish(r, out)
                else:
                    edges[s + 1] = self.mesh.hop(
                        [encode_edge(out, self.edge_bits)], 0, s)[0]
            self.stats["ticks"] += 1

    def _decode_wave(self, caches, cur_tok: torch.Tensor,
                     tokens: torch.Tensor, prompt_len: int, pick,
                     gens) -> None:
        """Waves 1..N-1: stage i serves slot (t - i) mod R at wave
        floor((t - i) / R) + 1; the last stage's pick lands in `tokens`
        [R, N, B] and in `cur_tok` [R, B], where stage 0 reads it."""
        n, slots = self.n_stages, cur_tok.shape[0]
        batch, n_waves = cur_tok.shape[1], tokens.shape[1] - 1
        edges: Dict[int, torch.Tensor] = {}
        for t in range(n_waves * slots + n - 1):
            for s in reversed(range(n)):
                m = t - s
                wave = m // slots + 1
                if m < 0 or wave > n_waves:
                    continue
                r = m % slots
                pos = prompt_len + wave - 1
                data = cur_tok[r] if s == 0 else edges.pop(s)
                out = self._step(s, data, self._slot(caches[s], r, batch),
                                 pos)
                if s == n - 1:
                    tok = pick(out[:, 0].float(), gens[r])
                    tokens[r, wave] = tok
                    cur_tok[r].copy_(tok, non_blocking=True)
                else:
                    edges[s + 1] = self.mesh.hop([out], 0, s)[0]
            self.stats["ticks"] += 1

    def _span_wave(self, spans: torch.Tensor, caches, pos: int, emit: str,
                   pick=None, gens=None) -> torch.Tensor:
        """ONE wave over [R, B, K] spans at cache offset `pos`, with the
        host `extend` semantics (K/V written at [pos, pos + K), causal
        within the span). `emit='pick_last'` returns the picked last-row
        token [R, B] (advancing `gens`), `'argmax_all'` the greedy argmax
        of every span row [R, K, B]; both on the last stage's device."""
        slots, batch, k = spans.shape
        shape = (slots, batch) if emit == "pick_last" else (slots, k, batch)
        out = torch.empty(shape, dtype=torch.long, device=self.last)

        def finish(r, logits):
            if emit == "pick_last":
                out[r] = pick(logits[:, k - 1].float(), gens[r])
            else:
                out[r] = logits.float().argmax(-1).T

        self._fill_wave(list(spans.to(self.first)), caches, batch, finish,
                        pos=pos)
        return out

    # -- prefix caching ----------------------------------------------------

    def _prefix_sig(self) -> Tuple:
        """Cache-compatibility stamp of wave prefix handles: per-stage
        block counts, max_len, dtype, KV geometry and the edge bits (the
        prefix's numerics)."""
        return ("spmd-prefix-v1",
                tuple(st["n_blocks"] for st in self.stages), self.max_len,
                str(self.dtype).replace("torch.", ""), self.cfg.kv_heads,
                self.cfg.head_dim, self.edge_bits)

    def check_prefix(self, prefix) -> None:
        sig = prefix.get("sig") if isinstance(prefix, dict) else None
        if sig is None:
            raise ValueError(
                "prefix is not a precompute_prefix handle (no 'sig' "
                "stamp); build it with this pipeline's precompute_prefix")
        if sig != self._prefix_sig():
            raise ValueError(
                "prefix handle was built by an incompatible wave "
                f"pipeline: handle sig {sig} vs {self._prefix_sig()}")

    @torch.inference_mode()
    def precompute_prefix(self, prefix_ids) -> Dict:
        """Prefill a shared prompt prefix once through the wave (a
        one-slot, batch-1 wave): the handle's per-stage [L, 1, T, ...]
        caches are tiled to every (slot, row) by a copy at
        `generate(prefix=)`. Exact for fp caches, as the host pipeline's
        prefix contract."""
        ids = torch.as_tensor(prefix_ids, dtype=torch.long, device=self.first)
        if ids.dim() == 1:
            ids = ids[None]
        if ids.dim() != 2 or ids.shape[0] != 1:
            raise ValueError("a shared prefix is one sequence [P] or "
                             f"[1, P]; got shape {tuple(ids.shape)}")
        p_len = ids.shape[1]
        dec.validate_capacity(self.cfg, self.max_len, p_len, 1)
        self.stats = {"ticks": 0, "stage_steps": 0}
        caches = self._fresh_caches(1)
        self._fill_wave([ids], caches, 1, lambda r, logits: None)
        return {"caches": caches, "len": p_len, "sig": self._prefix_sig()}

    def _tile_prefix(self, handle: Dict, rows: int) -> List[dec.Cache]:
        return [{k: v.repeat(1, rows, *([1] * (v.dim() - 2)))
                 for k, v in cache.items()} for cache in handle["caches"]]

    # -- generation --------------------------------------------------------

    def _check_ids(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.first)
        if ids.dim() != 3 or ids.shape[0] != self.n_stages:
            raise ValueError(f"ids must be [R={self.n_stages} slots, B, "
                             f"S_p], got {tuple(ids.shape)}")
        return ids

    def _prefill(self, ids: torch.Tensor, pick, gens):
        """The prefill wave of every slot: (caches, token 1 [R, B] on the
        last stage's device)."""
        slots, batch, _ = ids.shape
        caches = self._fresh_caches(slots * batch)
        token1 = torch.empty((slots, batch), dtype=torch.long,
                             device=self.last)

        def finish(r, logits):
            token1[r] = pick(logits[:, -1].float(), gens[r])

        self._fill_wave(list(ids), caches, batch, finish)
        return caches, token1

    @torch.inference_mode()
    def generate(self, ids, new_tokens: int, temperature: float = 0.0,
                 top_k: int = 0, seeds=None,
                 prefix: Optional[Dict] = None) -> torch.Tensor:
        """Decode R = n_stages concurrent prompts [R, B, S_p] ->
        [R, B, S_p + new_tokens] on the last stage's device.

        `temperature=0` is greedy; otherwise slot r samples from its own
        generator seeded `seeds[r]` (default r), one draw per picked
        token: its stream equals `DecodePipeline.generate(ids[r], ...,
        seed=seeds[r])`. `prefix` (from `precompute_prefix`) seeds every
        slot's cache with a shared prefix; `ids` is then each slot's
        suffix [R, B, S_s], its prompt pass one span wave at the prefix
        offset, and the result omits the prefix."""
        ids = self._check_ids(ids)
        slots, batch, prompt_len = ids.shape
        if new_tokens < 1:
            raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
        base = 0
        if prefix is not None:
            self.check_prefix(prefix)
            if prompt_len == 0:
                raise ValueError(
                    "prefix reuse needs a non-empty suffix (the span "
                    "produces the first token's logits)")
            base = prefix["len"]
        dec.validate_capacity(self.cfg, self.max_len, base + prompt_len,
                              new_tokens)
        seeds = list(range(slots) if seeds is None else seeds)
        if len(seeds) != slots:
            raise ValueError(f"seeds must have {slots} entries, got "
                             f"{len(seeds)}")
        pick = dec.make_token_picker(temperature, top_k)
        gens = ([torch.Generator(device=self.last).manual_seed(int(s))
                 for s in seeds] if temperature > 0.0 else [None] * slots)
        self.stats = {"ticks": 0, "stage_steps": 0}
        if prefix is None:
            caches, token1 = self._prefill(ids, pick, gens)
        else:
            caches = self._tile_prefix(prefix, slots * batch)
            token1 = self._span_wave(ids, caches, base, "pick_last", pick,
                                     gens)
        tokens = torch.empty((slots, new_tokens, batch), dtype=torch.long,
                             device=self.last)
        tokens[:, 0] = token1
        if new_tokens > 1:
            cur_tok = token1.to(self.first, non_blocking=True).clone()
            self._decode_wave(caches, cur_tok, tokens, base + prompt_len,
                              pick, gens)
        return torch.cat([ids.to(self.last), tokens.transpose(1, 2)], dim=2)


class SpmdSpeculativeDecoder:
    """Speculative decoding whose verify runs through the wave.

    One span wave (`emit='argmax_all'`) verifies ALL R slots'
    (gamma + 1)-token spans each round, every stage verifying another slot
    per tick. The draft is any host-driven `DecodePipeline` over the same
    vocabulary; its R x B rows flatten into one batch, so each draft step
    is one pass for the whole fleet.

    Greedy-exact per slot: a round accepts the MINIMUM matching prefix
    across all slots and rows, so every slot stays at one cache position
    and the wave's position arithmetic stays pure tick math. Slots that
    matched deeper re-derive those tokens next round; the output equals
    `SpmdDecodePipeline.generate(ids, n)` token for token. A round reads
    the card back once (how many proposals every slot accepted)."""

    def __init__(self, target: SpmdDecodePipeline, draft, gamma: int = 4):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError(
                "draft and target must share a vocabulary: "
                f"{draft.cfg.vocab_size} vs {target.cfg.vocab_size}")
        self.target = target
        self.draft = draft
        self.gamma = gamma
        self.last_acceptance_rate: Optional[float] = None

    @torch.inference_mode()
    def generate(self, ids, new_tokens: int) -> torch.Tensor:
        """Greedy-decode all R slots: [R, B, S_p] -> [R, B, S_p + N] on the
        target's last stage device, token for token the wave's own greedy
        generate."""
        tgt = self.target
        ids = tgt._check_ids(ids)
        slots, batch, prompt_len = ids.shape
        if new_tokens < 1:
            raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
        g = self.gamma
        dec.validate_capacity(tgt.cfg, tgt.max_len, prompt_len,
                              new_tokens + g)
        dec.validate_capacity(self.draft.cfg, self.draft.max_len,
                              prompt_len, new_tokens + g)
        greedy = dec.make_token_picker()
        tgt.stats = {"ticks": 0, "stage_steps": 0}
        t_caches, token1 = tgt._prefill(ids, greedy, [None] * slots)
        # the draft's prompt pass: the slots flatten into its batch
        _, d_caches = self.draft._prefill(
            ids.reshape(slots * batch, prompt_len).to(self.draft.device))

        pending = token1                                 # [R, B]
        known = [pending]     # committed continuation tokens, [R, B] each
        n_emitted, t_pos, d_pos = 1, prompt_len, prompt_len
        proposed = accepted = 0
        while n_emitted < new_tokens:
            # draft catch-up (committed tokens it has not seen) + gamma
            # proposals, on the flattened fleet batch
            catch = torch.stack([k.reshape(-1) for k in
                                 known[d_pos - prompt_len:]], dim=1)
            d_logits, d_caches = self.draft.extend(
                catch.to(self.draft.device), d_caches, d_pos)
            d_pos += catch.shape[1]
            props = [d_logits[:, -1].float().argmax(-1)]
            for _ in range(g - 1):
                d_logits, d_caches = self.draft.extend(
                    props[-1][:, None], d_caches, d_pos)
                props.append(d_logits[:, -1].float().argmax(-1))
                d_pos += 1
            props = torch.stack(props).reshape(g, slots, batch).to(tgt.last)
            # one span wave verifies every slot's pending + proposals
            spans = torch.cat([pending[:, :, None],
                               props.permute(1, 2, 0)], dim=2)
            targets = tgt._span_wave(spans, t_caches, t_pos, "argmax_all")
            # accept the minimum matching prefix across ALL slots and rows
            match = (props == targets[:, :g].transpose(0, 1)).flatten(1)
            a = int(match.all(1).cumprod(0).sum())
            proposed += g
            accepted += a
            known.extend([props[k] for k in range(a)] + [targets[:, a]])
            n_emitted += a + 1
            pending = targets[:, a]
            t_pos += a + 1
            d_pos = t_pos - 1 if a == g else t_pos
        self.last_acceptance_rate = accepted / proposed if proposed \
            else None
        gen = torch.stack(known[:new_tokens], dim=2)
        return torch.cat([ids.to(tgt.last), gen], dim=2)
