"""The fleet tooling's accounting on the CPU: ``launch/costing`` and
``launch/dryrun`` against the reference's.

* Mirrors of tests/test_costing.py: FLOPs of a dot, a 7-step loop, a
  gradient, a batched dot and remat, counted by ``costing.OpCounter``
  (the port's counterpart of the jaxpr walk; a Python loop runs every
  step, so the loop's count needs no trip count); collectives by kind
  and bytes from DTensor redistributions on a fake process group in a
  process of its own (the counterpart of the HLO parse), and an empty
  run; the reference's four analytic-memory cases, plus
  ``analytic_bytes`` pinned equal to the reference's over all ten archs x
  the four shapes x n_micro {1, 16}, and ``tree_bytes`` of the abstract
  parameters equal to the reference's, one arch of each family.
* Matmul-class FLOPs held to the reference's ``dot_general`` + conv
  FLOPs (its ``jaxpr_flops`` rule restricted to those two primitives,
  scans times their lengths): a smoke prefill and a smoke train step
  (remat "full", one micro-batch, an identity optimizer) of deepseek-7b
  in f32, exactly equal. zamba2 differs by a named amount (see
  ``test_ssd_matmul_flops_differ_by_the_named_products``).
* The dry-run CLI for mamba2-130m x decode_32k x single (256 fake ranks)
  in a process of its own: its parameter counts, model FLOPs, cache bytes
  and memory breakdown equal what the reference's functions give for the
  same cell, computed without lowering anything.
* zamba2-1.2b and deepseek-7b x decode_32k x single with TP-resident
  weights: the step is tensor-parallel over 'model' (no parameter
  all-gathered, rank 0's FLOPs x 256 within 1.25x of the step on one
  rank, zamba2's collective term ten times below the whole-weight
  step's).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as j_base  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.configs.shapes import SHAPES as J_SHAPES  # noqa: E402
from repro.launch import costing as j_costing  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models.factory import build_model as j_build  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.configs.shapes import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.launch import costing  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models.factory import build_model as t_build  # noqa: E402
from repro_torch.sharding.policy import MeshShape  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _count(fn, *args):
    return costing.count_ops(fn, *args)[1]


# ------------------------------------------------------------- op flops ---
def test_dot_flops_exact():
    c = _count(lambda a, b: a @ b, torch.randn(64, 32), torch.randn(32, 16))
    assert c.flops == c.matmul_flops == 2 * 64 * 32 * 16


def test_loop_flops_multiplied():
    def f(h, ws):
        for w in ws:
            h = torch.tanh(h @ w)
        return h
    c = _count(f, torch.randn(32, 32), torch.randn(7, 32, 32))
    assert c.flops == 7 * (2 * 32 ** 3 + 32 * 32)  # matmul + tanh per step


def test_grad_flops_counts_backward():
    w = torch.randn(32, 32, requires_grad=True)
    x = torch.randn(8, 32)
    c = _count(lambda: torch.autograd.grad(torch.tanh(x @ w).sum(), w))
    fwd = 2 * 8 * 32 * 32
    # bwd: dw = x^T @ dy (same flops); elementwise terms on top
    assert c.flops >= 2 * fwd


def test_batched_dot_flops():
    c = _count(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
               torch.randn(4, 8, 16), torch.randn(4, 16, 32))
    assert c.flops == 2 * 4 * 8 * 16 * 32


def test_remat_recompute_counted():
    from torch.utils.checkpoint import checkpoint
    w = torch.randn(32, 32)
    x = torch.randn(8, 32, requires_grad=True)

    def f():
        def g(xx):
            return checkpoint(lambda v: torch.tanh(v @ w), xx,
                              use_reentrant=False)
        return torch.autograd.grad(g(g(x)).sum(), x)
    c = _count(f)
    # 2 fwd + 2 recompute + 2 bwd dots minimum
    assert c.matmul_flops >= 6 * 2 * 8 * 32 * 32


def test_counting_refuses_a_cuda_tensor():
    """A CUDA tensor would reach the kernel wrappers' launch path; the
    counter raises instead (checked on a tensor that only reports a CUDA
    device: this machine may have no card)."""
    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)
    with pytest.raises(ValueError, match="CUDA"):
        costing.count_ops(lambda a: a + 1,
                          torch.zeros(2).as_subclass(OnCard))


# ---------------------------------------------------------- collectives ---
_COLLECTIVES = """
import json, torch, torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.launch import costing, dryrun
from repro_torch.launch.mesh import make_mesh_compat
dryrun.fake_world(4)
mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
x = torch.zeros(8, 16)
sharded = distribute_tensor(x, mesh, [Shard(0), Shard(1)],
                            src_data_rank=None)
partial = DTensor.from_local(torch.zeros(4, 16), mesh,
                             [Partial(), Replicate()], run_check=False)
with costing.OpCounter() as c:
    sharded.full_tensor()                                 # 2 all-gathers
    partial.full_tensor()                                 # 1 all-reduce
    partial.redistribute(mesh, [Shard(0), Replicate()])   # 1 reduce-scatter
print(json.dumps(c.collectives()))
"""


def test_collectives_by_kind_and_bytes():
    out = subprocess.run([sys.executable, "-c", _COLLECTIVES],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # bytes by hand, f32: the (4, 8) shard gathered over one axis (4, 16)
    # or (8, 8), then over the other (8, 16); the (4, 16) partial reduced
    # whole; then scattered into (2, 16) rows
    assert res["count_by_type"] == {"all-gather": 2, "all-reduce": 1,
                                    "reduce-scatter": 1}
    assert res["bytes_by_type"] == {"all-gather": (4 * 16 + 8 * 16) * 4.0,
                                    "all-reduce": 4 * 16 * 4.0,
                                    "reduce-scatter": 2 * 16 * 4.0}
    assert res["total_bytes"] == sum(res["bytes_by_type"].values())


def test_collectives_empty():
    c = _count(lambda: None)
    assert c.collectives()["total_bytes"] == 0 and c.flops == 0


# --------------------------------------------------------- memory model ----
def _shape(kind, **kw):
    base = dict(name="t", kind=kind, seq_len=4096, global_batch=8)
    base.update(kw)
    return t_base.ShapeConfig(**base)


def _arch(name):
    return t_registry.get_arch(name).replace(head_pad_to=16)


def test_analytic_bytes_train_scaling():
    arch = _arch("deepseek-7b")
    n = 7_000_000_000
    m1 = costing.analytic_bytes("train", arch, _shape("train"), n, 1, 0, 256)
    m16 = costing.analytic_bytes("train", arch, _shape("train"), n, 16, 0,
                                 256)
    # weight streams scale with microbatch count; optimizer traffic not
    assert m16.breakdown["weights"] == 16 * m1.breakdown["weights"]
    assert m16.breakdown["optimizer"] == m1.breakdown["optimizer"]


def test_analytic_bytes_decode_cache_dominates():
    arch = _arch("qwen2.5-32b")
    cache = 1.1e12
    m = costing.analytic_bytes(
        "decode", arch, _shape("decode", seq_len=32768, global_batch=128),
        33.4e9, 1, cache, 256)
    assert m.breakdown["cache_read"] == cache
    assert m.breakdown["cache_read"] > m.breakdown["weights"]


def test_prefill_last_only_cuts_logit_bytes():
    arch = _arch("qwen2.5-32b")
    full = costing.analytic_bytes(
        "prefill", arch, _shape("prefill", seq_len=32768, global_batch=32),
        33.4e9, 1, 0, 256)
    last = costing.analytic_bytes(
        "prefill", arch, _shape("prefill", seq_len=32768, global_batch=32,
                                prefill_last_only=True), 33.4e9, 1, 0, 256)
    assert last.breakdown["logits"] * 1000 < full.breakdown["logits"]


def test_chunked_attention_removes_score_traffic():
    arch = _arch("deepseek-v2-236b")
    dense = costing.analytic_bytes("train", arch,
                                   _shape("train", global_batch=256),
                                   239e9, 16, 0, 256)
    chunked = costing.analytic_bytes(
        "train", arch, _shape("train", global_batch=256,
                              train_attn_chunk=1024), 239e9, 16, 0, 256)
    assert chunked.breakdown["activations"] \
        < 0.5 * dense.breakdown["activations"]


@pytest.mark.parametrize("n_micro", [1, 16])
@pytest.mark.parametrize("shape", sorted(T_SHAPES))
@pytest.mark.parametrize("arch", sorted(t_registry.ARCHS))
def test_analytic_bytes_equal_the_reference(arch, shape, n_micro):
    """Same arguments, same breakdown, key for key (both compute in
    Python floats, in the same order)."""
    ta, ja = _arch(arch), j_registry.get_arch(arch).replace(head_pad_to=16)
    ts, js = T_SHAPES[shape], J_SHAPES[shape]
    args = (7_123_456_789, n_micro, 3.5e11, 256)
    got = costing.analytic_bytes(ts.kind, ta, ts, *args,
                                 weight_read_factor=16.0)
    want = j_costing.analytic_bytes(js.kind, ja, js, *args,
                                    weight_read_factor=16.0)
    assert got.breakdown == want.breakdown and got.total == want.total


@pytest.mark.parametrize("arch", [
    "deepseek-7b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
    "mamba2-130m", "zamba2-1.2b", "qwen2-vl-72b", "whisper-tiny"])
def test_tree_bytes_of_the_abstract_params_equal_the_reference(arch):
    """At published widths; deepseek-v2 (MLA) at 2 of its 60 layers, so
    that the abstract init stays quick."""
    kw = {"n_layers": 2} if arch == "deepseek-v2-236b" else {}
    cfg = j_registry.get_arch(arch).replace(head_pad_to=16, **kw)
    want = j_costing.tree_bytes(j_steps.abstract_params(j_build(cfg)))
    tm = t_build(_arch(arch).replace(**kw))
    got = costing.tree_bytes(t_steps.abstract_params(tm))
    assert got == want
    # TensorSpec leaves count their meta tensors
    mesh = MeshShape(("data", "model"), (16, 16))
    assert costing.tree_bytes(t_steps.params_sds(tm, mesh)[0]) == want


# ------------------------------------------- matmul FLOPs vs the jaxpr ----
def _dot_conv_flops(jaxpr) -> float:
    """The reference's ``jaxpr_flops`` rule restricted to dot_general and
    conv_general_dilated (scans times their lengths, cond's largest
    branch, call jaxprs recursed)."""
    jx = getattr(jaxpr, "jaxpr", jaxpr)
    total = 0.0
    for eqn in jx.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            total += j_costing._dot_flops(eqn)
        elif name == "conv_general_dilated":
            total += j_costing._conv_flops(eqn)
        elif name == "scan":
            total += eqn.params["length"] * _dot_conv_flops(
                eqn.params["jaxpr"])
        elif name == "while":
            total += _dot_conv_flops(eqn.params["body_jaxpr"])
        elif name == "cond":
            total += max(_dot_conv_flops(b) for b in eqn.params["branches"])
        else:
            for k in j_costing._CALL_PARAM_KEYS:
                if k in eqn.params:
                    total += _dot_conv_flops(eqn.params[k])
                    break
    return total


B, S = 4, 64


def _batch(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def _ident(opt_cls):
    return opt_cls(init=lambda p: {}, update=lambda g, s, p: (g, s, {}))


_FLOPS: dict = {}


def _flops(arch):
    """((reference prefill, port prefill), (reference train, port train))
    matmul-class FLOPs of a smoke config in f32, each pair with the port's
    and the reference's totals beside them (printed, not held)."""
    if arch in _FLOPS:
        return _FLOPS[arch]
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.transformer import params_from_jax
    from repro_torch.sharding.policy import place
    from repro_torch.train import optimizer as t_opt
    jc = j_registry.smoke_config(arch).replace(dtype="float32")
    tc = t_registry.smoke_config(arch).replace(dtype="float32")
    jm, tm = j_build(jc), t_build(tc)
    p = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
    batch = _batch(jc.vocab_size)

    jx = jax.make_jaxpr(lambda pp, t: jm.prefill(pp, {"tokens": t}))(
        p, jnp.asarray(batch["tokens"]))
    tc_pre = _count(lambda: tm.prefill(
        tp, {"tokens": torch.as_tensor(batch["tokens"])}))
    prefill = (_dot_conv_flops(jx), tc_pre.matmul_flops,
               j_costing.jaxpr_flops(jx), tc_pre.flops)

    cell = dict(name="t", kind="train", seq_len=S, global_batch=B,
                microbatch_seqs_per_shard=B, remat_policy="full")
    j_mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                               ("data", "model"))
    fn, _ = j_steps.make_train_step(jm, j_mesh, j_base.ShapeConfig(**cell),
                                    _ident(j_opt.Optimizer))
    with j_mesh:
        jx = jax.make_jaxpr(fn)(p, {}, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    t_fn, _ = t_steps.make_train_step(tm, mesh, t_base.ShapeConfig(**cell),
                                      _ident(t_opt.Optimizer))
    tc_train = _count(t_fn, place(tp, mesh), {}, batch)
    train = (_dot_conv_flops(jx), tc_train.matmul_flops,
             j_costing.jaxpr_flops(jx), tc_train.flops)
    print(f"{arch}: prefill matmul ref {prefill[0]:.0f} port {prefill[1]}, "
          f"totals ref {prefill[2]:.0f} port {prefill[3]}; train matmul "
          f"ref {train[0]:.0f} port {train[1]}, totals ref {train[2]:.0f} "
          f"port {train[3]}")
    _FLOPS[arch] = (prefill, train)
    return _FLOPS[arch]


def test_dense_matmul_flops_equal_the_reference_jaxpr():
    """deepseek-7b smoke, f32: the port's matmul-class FLOPs of a prefill
    and of a train step (forward, remat recompute, backward) equal the
    reference's dot_general FLOPs exactly.

    The totals (with the one-FLOP-an-element term) are printed and not
    held equal: the reference counts every jaxpr equation, reshapes,
    broadcasts and converts among them, where the port counts the ATen
    ops it dispatches (views and allocations count nothing, and one op
    may stand for several equations or the other way round)."""
    prefill, train = _flops("deepseek-7b")
    assert prefill[1] == prefill[0] > 0
    assert train[1] == train[0] > prefill[0]
    assert prefill[3] > prefill[1] and train[3] > train[1]


def test_ssd_matmul_flops_differ_by_the_named_products():
    """zamba2 smoke (4 Mamba-2 layers and the shared attention block), f32:
    the port's matmul-class FLOPs differ from the reference's dot_general
    FLOPs by exactly two named terms of the plain SSD (``ssd_chunked``),
    a layer:

    * the port's running sum over each chunk is a product with a triangle
      of ones (``models/ssm.py``: no deterministic CUDA cumsum), T = 2 B
      nc H L^2 FLOPs a forward pass and T again for its gradient; the
      reference computes a ``cumsum``, no dot;
    * the reference's three-operand einsums contract, pair by pair, three
      products with no summed index, which JAX emits as ``dot_general``
      and PyTorch's einsum as elementwise multiplications: decay x CB (D1
      = 2 B nc H L^2) and the two decay scalings (D2 = 2 B S H P each),
      and their gradients two products each.

    With L = min(chunk, S) and nc = S / L: a prefill differs by -2 D2 a
    layer (T cancels D1), a remat "full" train step (two forwards and a
    backward) by 3 T - 4 (D1 + 2 D2) = -(D1 + 8 D2) a layer. S is two
    chunks here: at one chunk the port's autograd skips the state
    products' backward (their output reaches no loss), which the
    reference's scan transpose computes."""
    tc = t_registry.smoke_config("zamba2-1.2b")
    s = tc.ssm
    h, p, lc = tc.ssm_heads_padded, s.head_dim, min(s.chunk_size, S)
    nc = S // lc
    assert nc == 2
    d1 = 2 * B * nc * h * lc * lc
    d2 = 2 * B * S * h * p
    (j_pre, t_pre, *_), (j_train, t_train, *_) = _flops("zamba2-1.2b")
    assert t_pre - j_pre == -2 * d2 * tc.n_layers
    assert t_train - j_train == -(d1 + 8 * d2) * tc.n_layers


# -------------------------------------------------------------- dry-run ---
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_dryrun_cell_equals_the_reference_accounting(tmp_path, monkeypatch,
                                                     shape_name):
    """mamba2-130m x decode_32k (and long_500k, whose one sequence every
    rank decodes whole) x single through the CLI (256 fake ranks, a
    process of its own) against the reference's counting functions on the
    same cell, none of which lowers anything."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", shape_name, "--mesh", "single",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads((tmp_path / f"mamba2-130m__{shape_name}__single.json")
                     .read_text())
    assert res["status"] == "ok" and res["chips"] == 256

    # the reference's dryrun module sets XLA_FLAGS when imported
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as j_dryrun
    arch = j_registry.get_arch("mamba2-130m").replace(head_pad_to=16)
    shape = J_SHAPES[shape_name]
    model = j_build(arch)
    shapes = j_steps.abstract_params(model)
    n_total = j_steps.count_params_from_shapes(shapes)
    n_active = j_steps.count_active_params(shapes, arch)
    cache = j_costing.tree_bytes(jax.eval_shape(lambda: model.init_cache(
        shape.global_batch, shape.seq_len, shape.kv_dtype)))
    mem = j_costing.analytic_bytes(shape.kind, arch, shape, n_total, 1,
                                   cache, 256)
    assert res["params"] == {"total": n_total, "active": n_active}
    assert res["model_flops_global"] == j_dryrun.model_flops(
        shape.kind, n_active, shape.global_batch, shape.seq_len)
    assert res["cache_bytes_global"] == cache
    assert res["mem_breakdown_global"] == mem.breakdown
    # the terms are the counts over hw's H100 figures
    from repro_torch.launch import hw
    terms = res["roofline_terms_s"]
    assert terms["compute_s"] == res["per_device"]["hlo_flops"] \
        / hw.PEAK_FLOPS_BF16
    assert terms["memory_s"] == mem.total / 256 / hw.HBM_BW
    assert terms["collective_s"] == \
        res["collectives"]["total_bytes"] / hw.NVLINK_BW > 0
    assert res["dominant"] == max(terms, key=terms.get)
    assert 0 < res["useful_flops_ratio"] < 1
    # rank 0's state and gathered bytes, counted from the specs
    from repro_torch.launch import dryrun
    t_model = t_build(t_registry.get_arch("mamba2-130m").replace(
        head_pad_to=16))
    mesh = MeshShape(("data", "model"), (16, 16))
    assert (res["step_info"]["state_bytes_rank"],
            res["step_info"]["gathered_bytes_rank"]) == dryrun.zero_bytes(
        t_steps.abstract_params(t_model),
        t_steps.params_sds(t_model, mesh)[1], mesh, T_SHAPES[shape_name])


# ------------------------------------------- dry-run, tensor-parallel ---
# the same cell on a fake world of one rank: the whole step on rank 0
_ONE_RANK = """
import json, sys
from repro_torch.launch import dryrun, mesh
dryrun.fake_world(1)
dryrun.fake_world = lambda world: None
mesh.make_production_mesh = lambda multi_pod=False, device=None: \\
    mesh.make_mesh_compat((1, 1), ("data", "model"), device)
res = dryrun.run_cell(sys.argv[1], sys.argv[2], False,
                      {"params_tp_only": True})
print(json.dumps({"flops": res["per_device"]["hlo_flops"],
                  "chips": res["chips"],
                  "tp": res["step_info"]["tensor_parallel"]}))
"""
# zamba2-1.2b x decode_32k x single's collective_s when every rank
# gathered every weight whole (the all-gather-weights step)
WHOLE_WEIGHTS_COLLECTIVE_S = 2.7619e-03


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-7b"])
def test_dryrun_decode_cell_computes_each_ranks_model_shard(tmp_path, arch):
    """<arch> x decode_32k x single, TP-resident weights
    (``params_tp_only``): the step is tensor-parallel, rank 0's
    collectives hold no all-gather (no parameter gathered, only
    activations all-reduced), rank 0's FLOPs x 256 are at most 1.25x the
    same step counted on a fake world of one rank (only the replicated
    leaves' work is repeated on every 'model' rank), and zamba2's
    collective term is at least ten times below the whole-weight step's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "decode_32k", "--mesh", "single", "--set",
         "params_tp_only=true", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    name = arch.replace(".", "_")
    res = json.loads((tmp_path / f"{name}__decode_32k__single.json")
                     .read_text())
    assert res["status"] == "ok" and res["chips"] == 256
    assert res["step_info"]["tensor_parallel"] is True
    kinds = res["collectives"]["count_by_type"]
    assert "all-gather" not in kinds and kinds.get("all-reduce", 0) > 0
    one = subprocess.run(
        [sys.executable, "-c", _ONE_RANK, arch, "decode_32k"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert one.returncode == 0, one.stderr[-2000:]
    whole = json.loads(one.stdout.strip().splitlines()[-1])
    assert whole["chips"] == 1 and whole["tp"] is False
    ratio = res["per_device"]["hlo_flops"] * 256 / whole["flops"]
    print(f"{arch}: rank 0 FLOPs x 256 / one rank's = {ratio:.4f}")
    assert 1.0 <= ratio <= 1.25
    if arch == "zamba2-1.2b":
        assert res["roofline_terms_s"]["collective_s"] <= \
            WHOLE_WEIGHTS_COLLECTIVE_S / 10


# ------------------------------------------------ dry-run, ZeRO bytes ---
@pytest.mark.parametrize("arch,names,shape", [
    ("deepseek-v2-236b", ("data", "model"), (16, 16)),
    ("zamba2-1.2b", ("data", "model"), (2, 1)),
    ("whisper-tiny", ("pod", "data", "model"), (2, 16, 16))])
def test_zero_bytes_equal_a_count_from_the_reference_specs(arch, names,
                                                           shape):
    """``dryrun.zero_bytes`` of a train_4k cell (``state_bytes_rank`` and
    ``gathered_bytes_rank``) against a count made here from the
    reference's specs of the parameters' shapes (the port's abstract
    tree, whose leaves tests/test_torch_train_substrate.py holds to the
    reference's, as ``ShapeDtypeStruct``s): the rank's shards of
    the parameters (bf16), AdamW's m and v (f32) and the gradient
    accumulator (f32); and the leaves sharded over the data-parallel
    axes, whole over them, of the largest layer plus those outside the
    stacks. deepseek-v2-236b on the production mesh holds the two under
    the card's 80 GB (the whole 'model' shard gathered and an f32
    accumulator of it were 94 GB)."""
    import types

    from jax.sharding import PartitionSpec
    from repro.sharding import policy as j_policy
    from repro_torch.launch import dryrun
    sizes = dict(zip(names, shape))
    model = t_build(t_registry.get_arch(arch).replace(head_pad_to=16))
    shapes = t_steps.abstract_params(model)
    jshapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), jnp.bfloat16 if x.dtype == torch.bfloat16
        else jnp.float32), shapes)
    specs = j_policy.param_pspecs(jshapes, types.SimpleNamespace(
        axis_names=names, devices=np.empty(shape)))
    spec_of = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, PartitionSpec))[0])
    state = outside = 0.0
    layer = {}
    for path, x in jax.tree_util.tree_flatten_with_path(jshapes)[0]:
        axes = [a for part in spec_of[path] if part is not None
                for a in ((part,) if isinstance(part, str) else part)]
        n = float(np.prod(x.shape))
        state += n / np.prod([sizes[a] for a in axes]) * (
            x.dtype.itemsize + 4 + 4 + 4)
        if any(a in ("pod", "data") and sizes[a] > 1 for a in axes):
            whole = n / np.prod([sizes[a] for a in axes if a == "model"]) \
                * x.dtype.itemsize
            top = path[0].key
            if top.endswith("layers"):
                layer[top] = layer.get(top, 0.0) + whole / x.shape[0]
            else:
                outside += whole
    want = (state, max(layer.values()) + outside)

    mesh = MeshShape(names, shape)
    got = dryrun.zero_bytes(shapes, t_steps.params_sds(model, mesh)[1],
                            mesh, T_SHAPES["train_4k"])
    assert got == pytest.approx(want, rel=1e-12)
    print(f"{arch} {shape}: state {got[0] / 1e9:.3f} GB, gathered "
          f"{got[1] / 1e9:.3f} GB a rank")
    if arch == "deepseek-v2-236b":
        assert 17e9 < got[0] < 18e9 and 0.6e9 < got[1] < 0.7e9
        assert sum(got) < 80e9
