"""FlowServe engine: DP groups + TE-shell, PD-colocated mode.

One :class:`~repro_torch.models.transformer.Model` and ONE parameter
set serve every DP group: each group's
:class:`~repro_torch.serving.backend.TorchBackend` holds a reference to
the shared weights (a copy per group would be 28 GiB at DeepSeek-V3
width cut to 4 layers) and its own decode cache. ``mtp_k > 0`` serves
with §4.6 MTP speculative decoding: each decode iteration drafts
``mtp_k`` tokens with the model's MTP head and verifies them.
``memory`` is what a model with cross-attention reads (a VLM's patch
embeddings, an encoder-decoder's frames), handed to every group's
backend.

``ctx`` (as the reference's ``FlowServeEngine(ctx=)``) serves on a mesh:
one process per rank, each running this engine on the same requests.
The model holds this rank's parameter blocks (``rules``, default
``LOGICAL_RULES``; given ``params`` must be in that layout, as
``Model.init`` or ``from_jax_params(ctx=)`` make them) and each DP
group's decode cache is this rank's block. Every rank samples from the
same all-gathered logits with the same seeds, so every rank emits the
same tokens.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.dp_group import DPGroup
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import PrefillScheduler
from repro_torch.serving.te_shell import TEShell
from repro_torch.serving.tokenizer import ByteTokenizer

PyTree = Any


class FlowServeEngine:
    def __init__(self, cfg: ModelConfig, params: Optional[PyTree] = None,
                 *, device="cuda", n_dp_groups: int = 2, max_batch: int = 4,
                 max_len: int = 256, seed: int = 0,
                 token_budget: int = 8192,
                 chunk_tokens: Optional[int] = None, mtp_k: int = 0,
                 memory=None, ctx=None, rules=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg, ctx=ctx, rules=rules)
        self.ctx = self.model.ctx
        if params is None:
            params = self.model.init(seed, device=self.device)
        self.params = params
        self.tokenizer = ByteTokenizer()
        self.max_len = max_len
        # per-group sampling seed: DP groups step in lockstep, so a
        # shared seed would draw identical Gumbel noise
        self.dps = [
            DPGroup(i, TorchBackend(self.model, params, max_len=max_len,
                                    memory=memory, seed=seed * 1000 + i,
                                    mtp_k=mtp_k, device=self.device),
                    max_batch=max_batch, max_len=max_len)
            for i in range(n_dp_groups)
        ]
        self.shell = TEShell(
            self.dps,
            n_layers=cfg.num_layers if cfg.has_moe else 1,
            n_experts=cfg.moe.num_experts if cfg.has_moe else 0,
            prefill_scheduler=PrefillScheduler(
                n_dps=n_dp_groups, token_budget=token_budget,
                chunk_tokens=chunk_tokens))
        self.waiting: List[Request] = []
        # prefill finished but no decode slot yet: retry admission each
        # step
        self._ready: List[tuple] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prompt_tokens is None:
            req.prompt_tokens = self.tokenizer.encode(req.prompt)
        self.waiting.append(req)

    def submit_text(self, prompt: str, max_new_tokens: int = 32,
                    **kw) -> Request:
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens, **kw)
        self.submit(req)
        return req

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: schedule + run prefill CHUNKS, admit
        completed prompts, decode everywhere.

        Prefill is chunk-granular (§4.3 token-budget admission): the
        shell's ``PrefillScheduler`` emits per-DP ``ChunkWork`` slices
        and each DP executes its chunks through the backend's
        ``prefill_chunk``. Decode runs in two phases: every DP group's
        decode+sample step is *launched* first (its kernels queue on the
        device), then the ``[B]`` int32 token vectors are collected."""
        for req in self.waiting:
            limit = max(self.max_len - req.max_new_tokens - 1, 16)
            if req.prompt_len > limit:
                req.prompt_tokens = req.prompt_tokens[-limit:]
            self.shell.submit_prefill(req)
        self.waiting = []
        for dp, works in zip(self.dps, self.shell.schedule_prefill_chunks()):
            for work in works:
                work.req.state = RequestState.PREFILLING
                done = dp.run_prefill_chunk(work)
                if done is not None:
                    self._ready.append((work.req, dp) + done)
        still_ready: List[tuple] = []
        for req, dp, cache1, logits in self._ready:
            if dp.can_admit(req):
                dp.admit(req, cache1, logits)
            else:
                still_ready.append((req, dp, cache1, logits))
        self._ready = still_ready
        for dp in self.dps:
            dp.decode_launch()
        produced = 0
        for dp in self.dps:
            produced += dp.decode_complete()
        return produced

    def run_eplb(self, n_npus: Optional[int] = None,
                 slots_per_npu: int = 1):
        """One EPLB pass over the shell's collected routing stats: build
        per-layer maps and install the stacked PlacementTable on every
        DP group's backend (each group swaps at its next decode-
        iteration boundary). Returns the activated per-layer maps ({}
        when the model has no routed experts or nothing was collected)."""
        if self.shell.collector is None:
            return {}
        maps = self.shell.plan_eplb(
            n_npus or max(len(self.dps), 1), slots_per_npu)
        if maps:
            self.shell.activate_maps(maps)
        return maps

    def record_expert_counts(self, counts) -> None:
        """Feed per-layer routed token counts [n_layers, n_experts] into
        the EPLB collector."""
        self.shell.record_expert_counts(counts)

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while (self.waiting or self._ready
               or self.shell.prefill_sched.pending
               or any(d.active for d in self.dps)):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("engine did not converge")
        for d in self.dps:
            d.drain()
        done: List[Request] = []
        for d in self.dps:
            done.extend(d.finished)
            d.finished = []
        return done

    def generate(self, prompts: Sequence[str], max_new_tokens: int = 32,
                 temperature: float = 0.0) -> List[str]:
        reqs = [self.submit_text(p, max_new_tokens,
                                 temperature=temperature) for p in prompts]
        self.run_until_done()
        by_id = {r.req_id: r for r in reqs}
        return [self.tokenizer.decode(by_id[r.req_id].output_tokens)
                for r in reqs]

    def close(self) -> None:
        for d in self.dps:
            d.close()
