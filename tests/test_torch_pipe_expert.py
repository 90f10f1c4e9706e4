"""The port's pipeline and MoE modes (``mmlspark_tpu_torch.ops.
pipeline_parallel``, ``ops.expert_parallel``, DNNModel's pipeline and
expert modes) against the JAX package's, on the CPU: every case of
``tests/test_pipe_expert.py`` as a port case. The port's meshes are
logical: every slot a CPU device (``make_mesh(..., devices=["cpu"] * n)``),
as on one card every slot is that card; the reference runs on conftest's 8
virtual CPU devices.

Bit for bit: the a2a dispatch's keep masks and slots (integer routing), the
errors. Within ``TOL`` of the largest magnitude: pipeline and MoE outputs
against the reference's and against a dense numpy reference (float32
matmuls over microbatches and slot batches of other shapes sum in other
orders; softmax and tanh in each library's own code).
"""

import numpy as np
import pytest
import torch


def _import_reference():
    """Import the JAX package through the u_histogram shim (see
    ``tests/test_torch_gbdt.py``). The JAX package itself is not changed."""
    from jax._src.lax import lax as lax_internal
    from jax.interpreters import batching

    saved = batching.primitive_batchers
    batching.primitive_batchers = {lax_internal.optimization_barrier_p: None}
    try:
        import mmlspark_tpu.ops.u_histogram  # noqa: F401
    finally:
        batching.primitive_batchers = saved


try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.dnn import DNNModel
from mmlspark_tpu_torch.ops.expert_parallel import a2a_slots, moe_apply, moe_apply_a2a
from mmlspark_tpu_torch.ops.pipeline_parallel import pipeline_apply
from mmlspark_tpu_torch.parallel.mesh import MeshConfig, make_mesh

TOL = 1e-5  # float32 outputs, of the largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for this file (the full run's 6 workers share
    the cores; default thread pools oversubscribe them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    import jax

    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.dnn import DNNModel as JDNNModel
    from mmlspark_tpu.ops import expert_parallel as jep
    from mmlspark_tpu.ops import pipeline_parallel as jpp
    from mmlspark_tpu.parallel import mesh as jmesh

    def mesh(n=None, **axes):
        devs = jax.devices()[:n] if n else None
        return jmesh.make_mesh(jmesh.MeshConfig(**axes), devices=devs)

    return dict(ep=jep, pp=jpp, mesh=mesh, MeshConfig=jmesh.MeshConfig,
                DNNModel=JDNNModel, Table=JTable)


def _mesh(n, **axes):
    return make_mesh(MeshConfig(**axes), devices=["cpu"] * n)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _stage_fn(params, h):
    w, b = params
    return torch.tanh(h @ w + b)


def _j_stage_fn(params, h):
    import jax.numpy as jnp

    w, b = params
    return jnp.tanh(h @ w + b)


def _stack_params(rng, stages, d):
    ws = (rng.normal(size=(stages, d, d)) * 0.5).astype(np.float32)
    bs = (rng.normal(size=(stages, d)) * 0.1).astype(np.float32)
    return (ws, bs)


def _sequential(params, x):
    ws, bs = params
    h = np.asarray(x, np.float64)
    for i in range(ws.shape[0]):
        h = np.tanh(h @ ws[i] + bs[i])
    return h


def _pipe_case(ref, stages, d, b, m, pipe, data=1, seed=0):
    rng = np.random.default_rng(seed)
    params = _stack_params(rng, stages, d)
    x = rng.normal(size=(b, d)).astype(np.float32)
    got = pipeline_apply(_stage_fn, tuple(map(torch.from_numpy, params)), torch.from_numpy(x),
                         _mesh(data * pipe, data=data, pipe=pipe), num_microbatches=m).numpy()
    want = np.asarray(ref["pp"].pipeline_apply(
        _j_stage_fn, params, x, ref["mesh"](data * pipe, data=data, pipe=pipe), m))
    _close(got, want)
    _close(got, _sequential(params, x))
    return got


class TestPipelineParallel:
    def test_matches_sequential(self, ref):
        _pipe_case(ref, stages=4, d=16, b=32, m=8, pipe=4)

    def test_single_microbatch_and_many(self, ref):
        for m in (1, 2, 16):
            _pipe_case(ref, stages=8, d=8, b=16, m=m, pipe=8, seed=1)

    def test_pipe_axis_one_falls_back(self, ref):
        _pipe_case(ref, stages=3, d=8, b=8, m=2, pipe=1, data=8, seed=2)

    def test_indivisible_batch_raises(self, ref):
        rng = np.random.default_rng(3)
        params = _stack_params(rng, 4, 8)
        x = rng.normal(size=(10, 8)).astype(np.float32)
        with pytest.raises(ValueError, match="not divisible") as e:
            pipeline_apply(_stage_fn, tuple(map(torch.from_numpy, params)),
                           torch.from_numpy(x), _mesh(4, data=1, pipe=4), num_microbatches=3)
        with pytest.raises(ValueError) as je:
            ref["pp"].pipeline_apply(_j_stage_fn, params, x, ref["mesh"](4, data=1, pipe=4), 3)
        assert str(e.value) == str(je.value)


def _expert_fn(params, x):
    w, b = params
    return x @ w + b


def _j_expert_fn(params, x):
    w, b = params
    return x @ w + b


def _moe_setup(e=4, b=24, d=8, seed=0, skew=None):
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(e, d, d)) * 0.3).astype(np.float32)
    bs = (rng.normal(size=(e, d)) * 0.1).astype(np.float32)
    x = rng.normal(size=(b, d)).astype(np.float32)
    gates = rng.normal(size=(b, e)).astype(np.float32)
    if skew is not None:
        gates[:, skew] += 10.0  # route (almost) everything to one expert
    return (ws, bs), x, gates


def _dense_reference(params, x, gates):
    ws, bs = params
    g = gates.astype(np.float64)
    probs = np.exp(g - g.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    assign = gates.argmax(axis=1)
    out = np.zeros((x.shape[0], ws.shape[2]))
    for i in range(x.shape[0]):
        e = assign[i]
        out[i] = (x[i].astype(np.float64) @ ws[e] + bs[e]) * probs[i, e]
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _moe_case(ref, mesh_axes, n, seed, a2a=False, cf=1.25, **setup):
    params, x, gates = _moe_setup(seed=seed, **setup)
    tp = tuple(map(_t, params))
    if a2a:
        got = moe_apply_a2a(_expert_fn, tp, _t(x), _t(gates), _mesh(n, **mesh_axes), cf)
        want = ref["ep"].moe_apply_a2a(_j_expert_fn, params, x, gates,
                                       ref["mesh"](n, **mesh_axes), cf)
    else:
        got = moe_apply(_expert_fn, tp, _t(x), _t(gates), _mesh(n, **mesh_axes))
        want = ref["ep"].moe_apply(_j_expert_fn, params, x, gates, ref["mesh"](n, **mesh_axes))
    got, want = got.numpy(), np.asarray(want)
    _close(got, want)
    return got, want, (params, x, gates)


class TestExpertParallel:
    def test_matches_reference(self, ref):
        got, _, (params, x, gates) = _moe_case(ref, dict(data=1, expert=4), 4, seed=0)
        _close(got, _dense_reference(params, x, gates))

    def test_expert_axis_one_falls_back(self, ref):
        got, _, (params, x, gates) = _moe_case(ref, dict(data=8, expert=1), 8, seed=1)
        _close(got, _dense_reference(params, x, gates))

    def test_all_axes_engaged(self, ref):
        """A (data=2, expert=4) mesh: the expert axis takes the experts."""
        got, _, (params, x, gates) = _moe_case(ref, dict(data=2, expert=4), 8, seed=2)
        _close(got, _dense_reference(params, x, gates))


def test_stage_count_mismatch_raises(ref):
    rng = np.random.default_rng(5)
    params = _stack_params(rng, 8, 8)  # 8 stages over a 4-way pipe
    x = rng.normal(size=(8, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="one stage per device") as e:
        pipeline_apply(_stage_fn, tuple(map(_t, params)), _t(x), _mesh(4, data=1, pipe=4),
                       num_microbatches=2)
    with pytest.raises(ValueError) as je:
        ref["pp"].pipeline_apply(_j_stage_fn, params, x, ref["mesh"](4, data=1, pipe=4), 2)
    assert str(e.value) == str(je.value)


def test_expert_count_mismatch_raises(ref):
    rng = np.random.default_rng(6)
    ws = rng.normal(size=(8, 8, 8)).astype(np.float32)
    bs = rng.normal(size=(8, 8)).astype(np.float32)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    gates = rng.normal(size=(8, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="one expert per device") as e:
        moe_apply(_expert_fn, (_t(ws), _t(bs)), _t(x), _t(gates), _mesh(4, data=1, expert=4))
    with pytest.raises(ValueError) as je:
        ref["ep"].moe_apply(_j_expert_fn, (ws, bs), x, gates, ref["mesh"](4, data=1, expert=4))
    assert str(e.value) == str(je.value)


class TestDNNModelConsumers:
    """The pipe/expert ops behind the PUBLIC DNNModel API — a user-facing
    transform engages the axes, not just the raw ops."""

    def test_pipeline_mode_through_dnnmodel(self, ref):
        rng = np.random.default_rng(0)
        d, n, p = 8, 24, 4
        params = _stack_params(rng, p, d)
        X = rng.normal(size=(n, d)).astype(np.float32)
        kw = dict(modelParams=params, feedDict={"x": "f"}, fetchDict={"y": "output"},
                  batchSize=8, numMicrobatches=2)
        out = DNNModel(pipelineStageFn=_stage_fn, meshConfig=_mesh(2 * p, data=2, pipe=p),
                       device="cpu", **kw).transform(Table({"f": X}))
        _close(out.column("y"), _sequential(params, X))
        want = ref["DNNModel"](pipelineStageFn=_j_stage_fn,
                               meshConfig=ref["MeshConfig"](data=2, pipe=p),
                               **kw).transform(ref["Table"]({"f": X}))
        _close(out.column("y"), want.column("y"))

    def test_moe_mode_through_dnnmodel(self, ref):
        rng = np.random.default_rng(1)
        d, n, e = 8, 30, 8
        experts = (
            (rng.normal(size=(e, d, d)) * 0.5).astype(np.float32),
            (rng.normal(size=(e, d)) * 0.1).astype(np.float32),
        )
        gate = rng.normal(size=(d, e)).astype(np.float32)
        X = rng.normal(size=(n, d)).astype(np.float32)

        def expert_fn(params, x):
            w, b = params
            return torch.tanh(x @ w + b)

        def j_expert_fn(params, x):
            import jax.numpy as jnp

            w, b = params
            return jnp.tanh(x @ w + b)

        kw = dict(modelParams={"experts": experts, "gate": gate}, feedDict={"x": "f"},
                  fetchDict={"y": "output"}, batchSize=10)
        out = DNNModel(expertFn=expert_fn, meshConfig=_mesh(e, data=1, expert=e),
                       device="cpu", **kw).transform(Table({"f": X}))

        # reference: dense per-token top-1 expert
        logits = X.astype(np.float64) @ gate
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        assign = (X @ gate).argmax(axis=1)
        want = np.zeros_like(X, dtype=np.float64)
        for i in range(n):
            w_, b_ = experts[0][assign[i]], experts[1][assign[i]]
            want[i] = np.tanh(X[i] @ w_ + b_) * probs[i, assign[i]]
        _close(out.column("y"), want)
        jwant = ref["DNNModel"](expertFn=j_expert_fn,
                                meshConfig=ref["MeshConfig"](data=1, expert=e),
                                **kw).transform(ref["Table"]({"f": X}))
        _close(out.column("y"), jwant.column("y"))

    def test_mode_exclusivity_raises(self, ref):
        errs = []
        for model in (DNNModel(applyFn=lambda p, i: i, pipelineStageFn=_stage_fn,
                               feedDict={"x": "f"}, fetchDict={"y": "output"}, device="cpu"),
                      DNNModel(feedDict={"x": "f"}, fetchDict={"y": "output"}, device="cpu")):
            with pytest.raises(ValueError, match="exactly one of") as e:
                model._program()
            errs.append(str(e.value))
        for model in (ref["DNNModel"](applyFn=lambda p, i: i, pipelineStageFn=_j_stage_fn,
                                      feedDict={"x": "f"}, fetchDict={"y": "output"}),
                      ref["DNNModel"](feedDict={"x": "f"}, fetchDict={"y": "output"})):
            with pytest.raises(ValueError) as e:
                model._jitted()
            errs.append(str(e.value))
        assert errs[:2] == errs[2:]

    def test_moe_params_shape_validated(self):
        m = DNNModel(
            expertFn=lambda p, x: x,
            modelParams={"gate": np.zeros((4, 2))},  # missing 'experts'
            feedDict={"x": "f"},
            fetchDict={"y": "output"},
            meshConfig=_mesh(1, data=1),
            device="cpu",
        )
        _, _, place = m._program()
        with pytest.raises(ValueError, match="experts"):
            place(m.getModelParams())


def test_pipeline_mode_unbatched_pads_to_microbatches(ref):
    """miniBatcher=False with a row count not divisible by numMicrobatches
    must pad internally instead of raising."""
    rng = np.random.default_rng(2)
    d, p = 8, 4
    params = _stack_params(rng, p, d)
    X = rng.normal(size=(10, d)).astype(np.float32)  # 10 % 4 != 0
    kw = dict(modelParams=params, feedDict={"x": "f"}, fetchDict={"y": "output"},
              miniBatcher=False, numMicrobatches=p)
    out = DNNModel(pipelineStageFn=_stage_fn, meshConfig=_mesh(2 * p, data=2, pipe=p),
                   device="cpu", **kw).transform(Table({"f": X}))
    _close(out.column("y"), _sequential(params, X))
    want = ref["DNNModel"](pipelineStageFn=_j_stage_fn,
                           meshConfig=ref["MeshConfig"](data=2, pipe=p),
                           **kw).transform(ref["Table"]({"f": X}))
    _close(out.column("y"), want.column("y"))


class TestExpertA2A:
    """Capacity-based all_to_all MoE dispatch (the GShard layout): tokens
    shard over the expert axis; overflow tokens drop to zero output."""

    def test_matches_masked_dense_when_capacity_ample(self, ref):
        # capacity_factor high enough that nothing drops
        got, _, (params, x, gates) = _moe_case(ref, dict(data=1, expert=4), 4, seed=0, a2a=True,
                                            cf=4.0, b=32)
        dense = moe_apply(_expert_fn, tuple(map(_t, params)), _t(x), _t(gates),
                          _mesh(4, data=1, expert=4)).numpy()
        _close(got, dense)

    def test_overflow_tokens_drop_to_zero(self, ref):
        got, _, (params, x, gates) = _moe_case(ref, dict(data=1, expert=4), 4, seed=0, a2a=True,
                                            cf=1.0, b=32, skew=2)  # everyone wants expert 2
        # per source: 8 local tokens, cap = ceil(8/4*1.0) = 2 slots for
        # expert 2 -> exactly 2 kept per device, 6 dropped (zero rows)
        zero_rows = (np.abs(got) < 1e-12).all(axis=1)
        assert zero_rows.sum() == 4 * 6, zero_rows.sum()
        want = _dense_reference(params, x, gates)
        _close(got[~zero_rows], want[~zero_rows])
        # the keep mask is the reference's, bit for bit
        keep, slot, _ = a2a_slots(_t(gates), 4, 2)
        np.testing.assert_array_equal(keep.numpy(), ~zero_rows)
        assert set(slot[keep].tolist()) <= set(range(2 * 2, 2 * 3))

    def test_a2a_masks_match_reference_on_random_routing(self, ref):
        """Capacity 1-3 over seeded, skewed routing: the same rows dropped as
        the reference's, every kept row within tolerance."""
        for seed, cf in ((3, 0.5), (4, 1.0), (5, 1.25)):
            got, want, _ = _moe_case(ref, dict(data=1, expert=4), 4, seed=seed, a2a=True,
                                     cf=cf, b=48, skew=seed % 4)
            np.testing.assert_array_equal((got == 0).all(axis=1), (want == 0).all(axis=1))

    def test_expert_axis_one_falls_back(self, ref):
        got, _, (params, x, gates) = _moe_case(ref, dict(data=8, expert=1), 8, seed=2, a2a=True,
                                            b=32)
        dense = moe_apply(_expert_fn, tuple(map(_t, params)), _t(x), _t(gates),
                          _mesh(8, data=8, expert=1)).numpy()
        np.testing.assert_array_equal(got, dense)

    def test_indivisible_batch_raises(self, ref):
        params, x, gates = _moe_setup(b=30)
        with pytest.raises(ValueError, match="not divisible") as e:
            moe_apply_a2a(_expert_fn, tuple(map(_t, params)), _t(x), _t(gates),
                          _mesh(4, data=1, expert=4))
        with pytest.raises(ValueError) as je:
            ref["ep"].moe_apply_a2a(_j_expert_fn, params, x, gates,
                                    ref["mesh"](4, data=1, expert=4))
        assert str(e.value) == str(je.value)
