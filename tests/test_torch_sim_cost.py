"""The SuperPod simulator's cost layer against the reference: the XCCL
latency models, the cost model's curves, ``from_calibration`` and the
``CostModelBackend`` contract.

Everything here is host arithmetic on Python and numpy floats, so the
port must give the reference's numbers exactly (``==``): the simulator's
trace digest hashes every event time to 9 decimals.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.transformerless import plan_partition as jax_plan
from repro.sim import fabric as jax_fabric
from repro.xccl import topology as jax_topo
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.transformerless import plan_partition as torch_plan
from repro_torch.sim import fabric as torch_fabric
from repro_torch.xccl import topology as torch_topo
from torch_parity import SIM_CALIBRATION_ROWS, write_sim_calibration

#: the 288/480 plan (MLA + MoE), a GQA MoE model and a dense one (no
#: expert dies: the colocated dispatch model and the attention-only MoE
#: term)
ARCHS = ["deepseek-v3-671b", "llama4-maverick-400b-a17b", "granite-8b"]


def _sides(arch: str, dies: int = 768):
    """(reference, port) cost models at ``arch`` on ``dies`` dies."""
    jc, tc = jax_get_config(arch), torch_get_config(arch)
    jp, tp = jax_plan(jc, dies), torch_plan(tc, dies)
    assert dataclasses.astuple(jp) == dataclasses.astuple(tp)
    return (jax_fabric.SuperPodCostModel(jc, jp),
            torch_fabric.SuperPodCostModel(tc, tp))


def _values(x):
    """Comparable plain values of a cost model's outputs."""
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    return x


# ---------------------------------------------------------------------------
# xccl/topology: the dispatch and A2E latency models
# ---------------------------------------------------------------------------
BPD = (1, 2, 3, 8, 16, 32, 48, 64, 96, 128)
EP = (32, 64, 128, 160, 256, 288)


@pytest.mark.parametrize("quantized", [True, False])
def test_dispatch_latency_model_equal(quantized):
    for bpd, ep, hidden in itertools.product(BPD, EP, (4096, 7168)):
        args = (bpd, hidden, ep, 8)
        assert torch_topo.dispatch_latency_model(*args, quantized) \
            == jax_topo.dispatch_latency_model(*args, quantized), args


@pytest.mark.parametrize("n_attn", [32, 160, 480])
def test_a2e_latency_model_equal(n_attn):
    for bpd, n_exp, hidden in itertools.product(BPD, EP, (4096, 7168)):
        args = (n_attn, n_exp, bpd, hidden, 8)
        assert torch_topo.a2e_latency_model(*args) \
            == jax_topo.a2e_latency_model(*args), args


def test_xccl_exports():
    import repro_torch.xccl as x
    for name in ("dispatch_latency_model", "a2e_latency_model"):
        assert name in x.__all__ and hasattr(x, name), name


# ---------------------------------------------------------------------------
# sim/fabric: SuperPodCostModel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_derived_terms_equal(arch):
    ref, port = _sides(arch)
    skip = {"cfg", "plan", "fabric"}
    want = {k: v for k, v in vars(ref).items() if k not in skip}
    got = {k: v for k, v in vars(port).items() if k not in skip}
    assert got == want
    # the simulated die's constants are the reference simulator's
    assert (torch_fabric.PEAK_FLOPS, torch_fabric.HBM_BW) \
        == (jax_fabric.PEAK_FLOPS, jax_fabric.HBM_BW)
    for name in ("DECODE_MFU", "PREFILL_MFU", "HBM_EFF", "INT8_MOE_SPEEDUP",
                 "ITER_OVERHEAD", "EXPERT_OP_OVERHEAD",
                 "PREFILL_CHUNK_OVERHEAD", "PREFILL_DECODE_CONTENTION"):
        assert getattr(torch_fabric, name) == getattr(jax_fabric, name)


IMBALANCES = [1.0, 1.7, 64.0, (1.0, 2.5, 1.2, 3.0, 1.0, 1.1, 4.0, 1.3),
              np.array([1.4, 2.0])]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_iter_time_equal(arch):
    ref, port = _sides(arch)
    for b, ctx, imb, mb, mtp, slots in itertools.product(
            (0, 1, 7, 32, 96), (0, 1, 1024, 8192), IMBALANCES,
            (None, 1, 2, 3), (0, 1, 2), (0, 288)):
        kw = dict(mean_context=ctx, moe_imbalance=imb, microbatches=mb,
                  mtp_k=mtp, placement_slots=slots, slowdown=1.5)
        assert port.decode_iter_time(b, **kw) \
            == ref.decode_iter_time(b, **kw), (b, kw)
    # the owner-gathered placement term and a measured draft overhead
    for m in (ref, port):
        m.placement_gather_free = False
        m.mtp_draft_overhead = 2.5e-3
    for b, slots, mtp in itertools.product((1, 96), (0, 288, 576), (0, 2)):
        assert port.decode_iter_time(b, 1024, placement_slots=slots,
                                     mtp_k=mtp) \
            == ref.decode_iter_time(b, 1024, placement_slots=slots,
                                    mtp_k=mtp)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_transfer_times_equal(arch):
    ref, port = _sides(arch)
    for n, ctx, dies, sl in itertools.product(
            (0, 1, 100, 2048, 8192), (0, 512, 16384), (1, 8, 16),
            (1.0, 1.25)):
        assert port.prefill_chunk_time(n, ctx, dies, sl) \
            == ref.prefill_chunk_time(n, ctx, dies, sl)
        assert port.prefill_time(n, dies, sl) == ref.prefill_time(n, dies,
                                                                   sl)
    for n, loads in itertools.product((0, 1, 333, 20000), (0, 1, 9)):
        assert port.kv_transfer_time(n) == ref.kv_transfer_time(n)
        assert port.reconfig_transfer_time(loads) \
            == ref.reconfig_transfer_time(loads)


def test_two_pod_fabric_equal():
    """Cross-pod paths price over the scale-out link (RoCE)."""
    topo = {}
    for name, top in (("ref", jax_topo), ("port", torch_topo)):
        topo[name] = top.PodTopology(
            pods=(top.PodSpec(chip_class="910C"),
                  top.PodSpec(chip_class="910B")), cross_fabric="roce")
    jc, tc = (jax_get_config("deepseek-v3-671b"),
              torch_get_config("deepseek-v3-671b"))
    ref = jax_fabric.SuperPodCostModel(
        jc, jax_plan(jc, 768), jax_fabric.FabricModel(topology=topo["ref"]))
    port = torch_fabric.SuperPodCostModel(
        tc, torch_plan(tc, 768),
        torch_fabric.FabricModel(topology=topo["port"]))
    for n, src, dst in itertools.product((1, 4096), (0, 1), (0, 1)):
        assert port.kv_transfer_time(n, src, dst) \
            == ref.kv_transfer_time(n, src, dst)
        assert port.fabric.link_fabric(src, dst) \
            == ref.fabric.link_fabric(src, dst)
    assert port.kv_transfer_time(4096, 1, 0) \
        > port.kv_transfer_time(4096, 0, 0)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_attn_times_equal(arch):
    ref, port = _sides(arch)
    for b, ctx, imb, mb in itertools.product(
            (0.5, 1, 7, 48, 96), (0, 1, 1024, 8192), (1.0, 1.7, 9.0),
            (None, 1, 2, 4)):
        assert _values(port.moe_attn_stage_times(b, ctx, imb, mb)) \
            == _values(ref.moe_attn_stage_times(b, ctx, imb, mb))
    for b, ctx, imb, mb, sl, esl, asl in itertools.product(
            (0, 1, 32, 96), (1, 1024), IMBALANCES, (None, 1, 3),
            (1.0, 2.0), (1.0, 3.0), (None, 4.0)):
        kw = dict(mean_context=ctx, moe_imbalance=imb, microbatches=mb,
                  slowdown=sl, expert_slowdown=esl, attn_stage_slowdown=asl)
        assert _values(port.moe_attn_decode_iter_time(b, **kw)) \
            == _values(ref.moe_attn_decode_iter_time(b, **kw)), (b, kw)


def _calibrated(fabric_mod, cfg, plan, paths, **kw):
    m = fabric_mod.SuperPodCostModel.from_calibration(cfg, plan, paths,
                                                      **kw)
    skip = {"cfg", "plan", "fabric"}
    return m, {k: v for k, v in vars(m).items() if k not in skip}


def test_from_calibration_equal(tmp_path):
    paths = write_sim_calibration(tmp_path)
    jc, tc = (jax_get_config("deepseek-v3-671b"),
              torch_get_config("deepseek-v3-671b"))
    jp, tp = jax_plan(jc, 768), torch_plan(tc, 768)
    ref, want = _calibrated(jax_fabric, jc, jp, list(paths),
                            decode_mfu=0.6)
    port, got = _calibrated(torch_fabric, tc, tp, list(paths),
                            decode_mfu=0.6)
    assert got == want
    # every row kind took effect (µs rows as the reader converts them),
    # clipped where the reader clips
    assert port.decode_mfu == 0.6
    assert port.iter_overhead == 512.25 * 1e-6
    assert port.expert_op_overhead == 33.5 * 1e-6
    assert port.prefill_decode_contention == 1.37
    assert port.prefill_hit_skip == 0.6036
    assert port.prefix_remote_seed == 1.0 and port.mtp_acceptance == 0.0
    assert port.mtp_draft_overhead == 2500.0 * 1e-6
    assert port.placement_gmm_overhead == 50.0 * 1e-6
    assert [c[0] for c in port._calib_comm] == [8.0, 32.0, 96.0]
    assert port._calib_comm[1][1:] == (180.0 * 1e-6,) * 2   # no combine_us
    assert [c[0] for c in port._calib_prefill] == [512.0, 2048.0]
    # the curves price between and beyond their points alike
    for b in (1, 8, 20, 52, 96, 200):
        assert port._comm_times(b) == ref._comm_times(b)
        assert port.decode_iter_time(b, 1024, placement_slots=288) \
            == ref.decode_iter_time(b, 1024, placement_slots=288)
        assert _values(port.moe_attn_decode_iter_time(b, 1024)) \
            == _values(ref.moe_attn_decode_iter_time(b, 1024))
    for n in (1, 512, 1000, 2048, 4096):
        assert port.prefill_chunk_time(n, 300) \
            == ref.prefill_chunk_time(n, 300)
    # a single path as a string, and clipping of the contention below 1
    one = tmp_path / "one.json"
    one.write_text('{"rows": [{"name": "prefill/decode_contention", '
                   '"us_per_call": 0.5}]}')
    assert _calibrated(torch_fabric, tc, tp, str(one))[1] \
        == _calibrated(jax_fabric, jc, jp, str(one))[1]
    assert torch_fabric.SuperPodCostModel.from_calibration(
        tc, tp, str(one)).prefill_decode_contention == 1.0
    for mod, cfg, plan in ((jax_fabric, jc, jp), (torch_fabric, tc, tp)):
        with pytest.raises(AttributeError, match="not_a_constant"):
            mod.SuperPodCostModel.from_calibration(cfg, plan, str(one),
                                                   not_a_constant=1.0)
    assert len(SIM_CALIBRATION_ROWS) == 14


# ---------------------------------------------------------------------------
# sim/fabric: CostModelBackend
# ---------------------------------------------------------------------------
def _backend_log(fabric_mod, cfg, plan, mtp_k: int):
    cost = fabric_mod.SuperPodCostModel(cfg, plan)
    cost.mtp_acceptance = 0.6
    be = fabric_mod.CostModelBackend(3, cost, mtp_k=mtp_k)
    log = [be.vocab_size, be.supports_chunked_prefill,
           be.supports_prefix_kv, be.mtp_k]
    cache = be.init_cache(4, 64)
    log.append(cache)
    c1, logits = be.prefill([5, 9, 11, 2])
    log += [c1, logits.dtype.str, logits.tolist()]
    # chunked: the last chunk's logits are the whole prompt's
    c = None
    for off, toks in ((0, [5, 9]), (2, [11]), (3, [2])):
        c, lg = be.prefill_chunk(c, toks, off, 4)
        log.append((c, None if lg is None else lg.tolist()))
    for bad in ((None, [1], 1, 4), (c, [1], 9, 12)):
        with pytest.raises(ValueError) as e:
            be.prefill_chunk(*bad)
        log.append(str(e.value))
    kv = be.slice_prefill_kv(c1, [5, 9, 11, 2], 1, 3)
    seeded = be.seed_prefill_cache([kv, {"tok_sum": 4, "n": 1}], 3, 4)
    log += [kv, seeded, be.prefill_chunk(seeded, [2], 3, 4)[1].tolist()]
    log.append(be.write_slot(cache, c1, 2))
    toks = np.array([[3], [9], [0], [63]], np.int32)
    pos = np.array([4, 7, 0, 100], np.int32)
    logits, _ = be.decode(cache, toks, pos)
    log.append(logits.tolist())
    for temps, step in ((np.zeros(4, np.float32), 0),
                        (np.array([0.0, 1.0, 0.7, 2.0], np.float32), 5),
                        (np.array([0.0, 1.0, 0.7, 2.0], np.float32), 6)):
        nxt, _ = be.decode_sample(cache, toks, pos, temps, step)
        log.append((nxt.dtype.str, nxt.tolist()))
    if mtp_k:
        mc = be.init_mtp_cache(4, 64)
        log += [mc, be.reset_mtp_slot(mc, 1)]
        for temps, step in ((np.zeros(4, np.float32), 2),
                            (np.array([0.0, 0.5, 1.0, 0.0], np.float32),
                             3)):
            block, n_acc, _, _ = be.decode_sample_mtp(cache, mc, toks, pos,
                                                      temps, step)
            log.append((block.dtype.str, block.tolist(), n_acc.dtype.str,
                        n_acc.tolist()))
    else:
        with pytest.raises(NotImplementedError):
            be.decode_sample_mtp(cache, None, toks, pos,
                                 np.zeros(4, np.float32), 0)
    be.apply_placement("table")
    log += [be.placement, be.n_placement_swaps, be.n_prefills,
            be.n_prefill_chunks, be.n_prefill_seeds, be.n_decode_steps]
    return log


@pytest.mark.parametrize("mtp_k", [0, 1, 2])
def test_cost_backend_contract_equal(mtp_k):
    jc, tc = (jax_get_config("deepseek-v3-671b"),
              torch_get_config("deepseek-v3-671b"))
    got = _backend_log(torch_fabric, tc, torch_plan(tc, 768), mtp_k)
    want = _backend_log(jax_fabric, jc, jax_plan(jc, 768), mtp_k)
    assert got == want
    # derived from the port's contract class, with the reference's plain
    # class attribute for chunking
    from repro_torch.serving.backend import ExecutionBackend
    assert issubclass(torch_fabric.CostModelBackend, ExecutionBackend)
    assert torch_fabric.CostModelBackend.__dict__[
        "supports_chunked_prefill"] is True


# ---------------------------------------------------------------------------
# serving/eplb: the array forms the simulator's EPLB passes run, against
# the reference's loops
# ---------------------------------------------------------------------------
def test_eplb_array_forms_equal_reference_loops():
    from repro.serving import eplb as jax_eplb
    from repro_torch.serving import eplb as torch_eplb

    rng = np.random.default_rng(0)
    for trial in range(200):
        E, T = int(rng.integers(2, 40)), int(rng.integers(1, 9))
        counts = rng.integers(0, 60, (E, T)) * (rng.random((E, T)) < 0.6)
        budget = int(rng.integers(0, 12))
        assert torch_eplb.select_redundant_experts(counts, budget) \
            == jax_eplb.select_redundant_experts(counts, budget), trial
        reps = {int(e): int(rng.integers(1, 4)) for e in range(E)
                if rng.random() < 0.5}
        assert torch_eplb.simulated_layer_load(counts, reps) \
            == jax_eplb.simulated_layer_load(counts, reps), trial
        # per-layer maps: absent, disabled, partial, with replicas
        maps = {"ref": [], "port": []}
        for _ in range(int(rng.integers(1, 5))):
            if rng.random() < 0.25:
                maps["ref"].append(None)
                maps["port"].append(None)
                continue
            nxt, replicas = E, {}
            for e in range(E):
                if e == 0 or rng.random() < 0.7:
                    k = int(rng.integers(0, 3))
                    replicas[e] = [e] + list(range(nxt, nxt + k))
                    nxt += k
            on = bool(rng.random() < 0.8)
            maps["ref"].append(jax_eplb.ExpertMap(E, replicas, enabled=on))
            maps["port"].append(torch_eplb.ExpertMap(
                E, {e: list(s) for e, s in replicas.items()}, enabled=on))
        pad = (None if rng.random() < 0.5 else E + int(rng.integers(0, 9)),
               None if rng.random() < 0.5 else int(rng.integers(1, 5)))
        want = jax_eplb.build_placement_table(maps["ref"], E, *pad)
        got = torch_eplb.build_placement_table(maps["port"], E, *pad)
        for name in ("replica_slots", "n_replicas", "phys_owner"):
            a, b = np.asarray(getattr(got, name)), \
                np.asarray(getattr(want, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), (trial, name)
