"""The port's training path against the JAX package: the loss, every
family's ``loss_fn`` and gradients, remat, microbatches, the train step,
and the flash attention backward's plain versions and autograd function.

Reduced configs, weights from the reference's ``init_params`` converted
to f32 masters (``convert.params_from_jax(master=True)``), batches from
numpy seeds.

Tolerances:
- ``softmax_xent`` and the flash backward's plain versions on identical
  f32 inputs: f32 ``TOL`` (``tests/test_kernels.py:18``, rtol 1e-4) or
  tighter.
- Losses and gradients as the models run, in bf16 from f32 masters: the
  loss within the bf16 ``TOL`` (2e-2 relative); each leaf's gradient
  within a relative Frobenius error of 2e-2, or of twice the reference's
  own spread where that is larger, but never above 5e-2. The spread is
  the largest relative difference of any leaf between the reference's
  compiled run and its op-by-op run (``jax.disable_jit``), the same
  function rounded in other places. Spread, bound and the port's largest
  leaf error on these configs: olmo-1b 0.012, 0.025, 0.014;
  codeqwen1.5-7b 0.020, 0.040, 0.022; qwen2-vl-7b 0.023, 0.046, 0.024;
  rwkv6-7b 0.024, 0.047, 0.036; recurrentgemma-9b 0.033, 0.050 (capped),
  0.042; whisper-tiny 0.015, 0.031, 0.015.
- The same losses and gradients with both packages computing in f32
  (their ``COMPUTE_DTYPE`` set to f32 in a subprocess of their own, so
  no module state of this process changes): each leaf within 1e-4
  relative, which shows the formulas are the reference's.
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

from _torch_parity import (LOSS_RTOL, flat,  # noqa: E402
                           port_loss_and_grads, port_routes,
                           reference_loss_and_grads, reference_routes,
                           routes_differ_at_ties_only, train_batch)
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import compute_view, params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL32 = dict(rtol=1e-4, atol=1e-5)
#: one config a family: dense (and dense with qkv biases), vlm, ssm,
#: hybrid, encdec, MoE with GQA and with MLA (and shared experts)
ARCHS = ["olmo-1b", "codeqwen1.5-7b", "qwen2-vl-7b", "rwkv6-7b",
         "recurrentgemma-9b", "whisper-tiny", "olmoe-1b-7b",
         "deepseek-v2-lite-16b"]
GRAD_REL = 2e-2
#: the most the reference's own spread may widen GRAD_REL to
GRAD_REL_CAP = 5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0):
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    return jcfg, cfg, jget_model(jcfg).init_params(jcfg,
                                                   jax.random.PRNGKey(seed))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_errors(got: dict, want: dict) -> dict:
    """Each non-empty leaf's relative Frobenius error (olmo's
    non-parametric norms are empty leaves)."""
    assert set(got) == set(want), set(got) ^ set(want)
    return {k: _rel(got[k], w) for k, w in want.items() if w.size}


# --- the loss -----------------------------------------------------------------------

def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((3, 5, 97))).astype(np.float32)
    labels = rng.integers(0, 97, (3, 5)).astype(np.int32)
    for z in (1e-4, 0.0):
        want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                               z_loss=z)
        got = L.softmax_xent(torch.tensor(logits), torch.tensor(labels),
                             z_loss=z)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_model_registry_trains_every_family_but_moe():
    """``ModelApi`` has the reference's training entry for every family,
    MoE included: ``loss_fn`` is the family module's (the MoE one adds the
    load-balance loss), ``make_train_step`` takes each, and dense, vlm
    and MoE have their ``init_decode_state``."""
    from repro_torch.models import griffin, moe, rwkv6, transformer, whisper
    for arch, mod in (("olmo-1b", transformer), ("qwen2-vl-7b", transformer),
                      ("rwkv6-7b", rwkv6), ("recurrentgemma-9b", griffin),
                      ("whisper-tiny", whisper), ("olmoe-1b-7b", moe),
                      ("deepseek-v2-lite-16b", moe)):
        cfg = get_config(arch).reduced()
        api = get_model(cfg)
        assert api.loss_fn is mod.loss_fn
        assert api.init_decode_state is mod.init_decode_state
        assert jget_model(jget(arch).reduced()).loss_fn is not None
        assert callable(make_train_step(cfg))


# --- every family's loss and gradients ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The loss within the bf16 TOL and each leaf's gradient within the
    module's bound. A MoE model's router may pick other experts than the
    reference's for a token at a near-tie, as the reference's own two runs
    may (the finding behind ``close_to_reference``); one token moved
    between experts moves those experts' gradients by a few percent. So
    its gradients are held against the reference routed as the port
    routed (``reference_routes``, op by op), and every token routed
    otherwise must be a near-tie (``routes_differ_at_ties_only``)."""
    jcfg, cfg, jp = _setup(arch)
    nb = train_batch(cfg)
    jl, jg = reference_loss_and_grads(jcfg, jp, nb)
    _, jg_eager = reference_loss_and_grads(jcfg, jp, nb, eager=True)
    with port_routes() as routes:
        tl, tg = port_loss_and_grads(cfg, jp, nb)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    spread = max(_rel_errors(jg_eager, jg).values())
    bound = min(max(GRAD_REL, 2 * spread), GRAD_REL_CAP)
    if cfg.family == "moe":
        assert len(routes) == cfg.num_layers
        picks = [idx for _, idx in routes]
        with reference_routes(picks) as ref_probs, jax.disable_jit():
            jget_model(jcfg).forward(jcfg, jp, {k: jnp.asarray(v)
                                                for k, v in nb.items()})
        routes_differ_at_ties_only(routes, ref_probs)
        jl, jg = reference_loss_and_grads(jcfg, jp, nb, routes=picks)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    else:
        assert not routes
    errs = _rel_errors(tg, jg)
    bad = {k: e for k, e in errs.items() if not e <= bound}
    assert not bad, (bound, bad)


F32_PARITY = """
import json, sys
import jax, jax.numpy as jnp, numpy as np, torch
import repro.models.layers as JL
import repro_torch.convert as CV
import repro_torch.models.layers as TL
JL.COMPUTE_DTYPE = jnp.float32
TL.COMPUTE_DTYPE = CV.COMPUTE_DTYPE = torch.float32
from _torch_parity import (port_loss_and_grads, reference_loss_and_grads,
                           train_batch)
from repro.configs import get_config as jget
from repro.models import get_model as jget_model
from repro_torch.configs import get_config
torch.set_num_threads(1)
out = {}
for arch in sys.argv[1:]:
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    jp = jget_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    nb = train_batch(cfg)
    jl, jg = reference_loss_and_grads(jcfg, jp, nb)
    tl, tg = port_loss_and_grads(cfg, jp, nb)
    errs = {k: float(np.linalg.norm(tg[k] - w)
                     / max(np.linalg.norm(w), 1e-30))
            for k, w in jg.items() if w.size}
    out[arch] = [tl, jl, errs]
print(json.dumps(out))
"""


def test_f32_loss_and_grads_match_reference():
    """Both packages in f32 (a subprocess, so this process's modules keep
    their dtypes): the same loss and every leaf's gradient within 1e-4
    relative, for every family."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]), "JAX_PLATFORMS": "cpu",
        "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", F32_PARITY, *ARCHS], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert sorted(out) == sorted(ARCHS)
    for arch, (tl, jl, errs) in out.items():
        assert abs(tl - jl) <= 1e-5 * abs(jl), (arch, tl, jl)
        bad = {k: e for k, e in errs.items() if not e <= 1e-4}
        assert errs and not bad, (arch, bad)


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-7b", "recurrentgemma-9b",
                                  "whisper-tiny", "olmoe-1b-7b",
                                  "deepseek-v2-lite-16b"])
def test_remat_gives_the_same_loss_and_grads(arch):
    """``remat=True`` recomputes each block in the backward (the
    reference's ``jax.checkpoint``): the same numbers as without."""
    _, cfg, jp = _setup(arch)
    nb = train_batch(cfg, seed=1)
    l0, g0 = port_loss_and_grads(cfg, jp, nb, remat=False)
    l1, g1 = port_loss_and_grads(cfg, jp, nb, remat=True)
    assert l0 == l1
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_training_forward_leaves_no_state_behind(arch):
    """The recurrent families' full-sequence forward starts from a zero
    state it builds itself and writes nothing in place: the logits equal
    the serving prefill's last row, and a second call gives the same."""
    _, cfg, _ = _setup(arch)
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device="cpu")
    toks = torch.tensor(train_batch(cfg)["tokens"])
    with torch.no_grad():
        a = api.forward(cfg, params, {"tokens": toks})
        b = api.forward(cfg, params, {"tokens": toks})
        last, _ = api.prefill(cfg, params, {"tokens": toks})
    assert torch.equal(a, b)
    np.testing.assert_allclose(a[:, -1].numpy(), last.numpy(), rtol=1e-5,
                               atol=1e-5)


# --- the train step -------------------------------------------------------------------

def _master(jp):
    return params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                           master=True)


def _batches(cfg, n, batch_size=4, seq_len=16):
    return [train_batch(cfg, batch_size, seq_len, seed=10 + i)
            for i in range(n)]


def test_two_microbatches_match_one_batch():
    """Gradients of two half batches summed in f32 and averaged: the
    loss and the pre-clip gradient norm of the whole batch, and after one
    step the same first moment (m = 0.1 x the clipped gradient) within a
    relative norm of 1e-2: each microbatch's weight gradient is a bf16
    product (the gradient of the bf16 compute view, as in the reference)
    rounded before the f32 sum, 2^-9 relative."""
    _, cfg, jp = _setup("olmo-1b")
    (nb,) = _batches(cfg, 1)
    batch = {k: torch.tensor(v) for k, v in nb.items()}
    out = {}
    for mb in (1, 2):
        params = _master(jp)
        opt = adamw_init(params)
        step = make_train_step(cfg, lr=1e-3, warmup=1, total=10,
                               remat=False, microbatches=mb)
        params, opt, m = step(params, opt, batch)
        out[mb] = (float(m["loss"]), float(m["grad_norm"]),
                   {k: v.numpy() for k, v in flat(opt.m).items()})
    assert abs(out[2][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    assert abs(out[2][1] - out[1][1]) <= 1e-4 * abs(out[1][1])
    for k, m1 in out[1][2].items():
        if m1.size:
            assert _rel(out[2][2][k], m1) < 1e-2, k


@pytest.mark.parametrize("arch,microbatches", [("olmo-1b", 1),
                                               ("olmo-1b", 2),
                                               ("qwen2-vl-7b", 1),
                                               ("olmoe-1b-7b", 1),
                                               ("deepseek-v2-lite-16b", 1)])
def test_train_steps_match_reference(arch, microbatches):
    """Three steps of ``make_train_step`` (AdamW at lr 1e-3, warmup 2, a
    cosine over 10, the global-norm clip; ``microbatches`` slices of the
    batch) against the reference's on three batches, from the same f32
    params: each step's loss within the bf16 TOL, the pre-clip gradient
    norm within 5%, the learning rate, and the total update within a
    relative norm of 0.1 over all leaves and of 0.2 per leaf. Adam's
    first steps are sign-like, so an element whose gradient is near zero
    may move either way in either package. The key bias ``bk`` is held
    only within the total: softmax is nearly invariant to it (only
    RoPE's rotation of k + bk tells its directions apart), so its
    gradient is mostly bf16 rounding. A MoE model's reference steps run
    op by op, routed as the port's step routed (see
    ``test_loss_and_grads_match_reference``)."""
    jcfg, cfg, jp = _setup(arch)
    nbs = _batches(cfg, 3)
    kw = dict(lr=1e-3, warmup=2, total=10, remat=False,
              microbatches=microbatches)
    jstep = jax.jit(jsteps.make_train_step(jcfg, **kw))
    jparams, jopt = jp, jadamw_init(jp)
    params = _master(jp)
    opt = adamw_init(params)
    step = make_train_step(cfg, **kw)
    for nb in nbs:
        with port_routes() as routes:
            params, opt, m = step(params, opt, {k: torch.tensor(v)
                                                for k, v in nb.items()})
        jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
        if cfg.family == "moe":
            assert len(routes) == cfg.num_layers * microbatches
            with reference_routes([idx for _, idx in routes]), \
                    jax.disable_jit():
                jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        else:
            jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-2)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(opt.step) == int(jopt.step) == 3
    p0 = {k: np.asarray(v, np.float64) for k, v in flat(jp).items()}
    want = {k: np.asarray(v, np.float64) - p0[k]
            for k, v in flat(jparams).items()}
    got = {k: p.detach().double().numpy() - p0[k]
           for k, p in flat(params).items()}
    for k in want:
        if want[k].size and k != "blocks/bk":
            assert _rel(got[k], want[k]) < 0.2, k
    total = np.concatenate([got[k].ravel() for k in sorted(got)])
    assert _rel(total, np.concatenate([want[k].ravel()
                                       for k in sorted(got)])) < 0.1


# --- the flash attention backward -----------------------------------------------------

# (B, H, KV, S, T, dh, causal): G 1 / 4 / 7, dh 64 / 128, S < T (suffix
# queries), not causal with S != T (whisper's cross attention)
FLASH_CASES = [
    (2, 4, 4, 24, 24, 64, True),
    (1, 8, 2, 20, 20, 128, True),
    (2, 7, 1, 17, 17, 64, True),
    (2, 4, 2, 12, 40, 128, True),
    (2, 6, 6, 21, 21, 64, False),
    (2, 6, 6, 9, 30, 64, False),
]


def _inputs(B, H, KV, S, T, dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, dh), (B, T, KV, dh), (B, T, KV, dh),
                      (B, S, H, dh))]


def _autograd_of_plain(q, k, v, do, **kw):
    """(dq, dk, dv) by torch autograd through ``ref.mha_attention``."""
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    ref.mha_attention(*ts, **kw).backward(torch.tensor(do))
    return [t.grad for t in ts]


@pytest.mark.parametrize("B,H,KV,S,T,dh,causal", FLASH_CASES)
def test_plain_backward_is_the_gradient_of_attention(B, H, KV, S, T, dh,
                                                     causal):
    """``ref.flash_attention_bwd`` (the kernels' formulas in f32) against
    torch autograd of ``ref.mha_attention`` and ``jax.grad`` of the
    reference's ``layers.gqa_attention`` under the same mask."""
    q, k, v, do = _inputs(B, H, KV, S, T, dh)
    got = ref.flash_attention_bwd(*(torch.tensor(a) for a in (q, k, v, do)),
                                  causal=causal)
    for g, want in zip(got, _autograd_of_plain(q, k, v, do, causal=causal)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), **TOL32)
    mask = JL.causal_mask(S, T, q_offset=T - S) if causal else None

    def attn(q_, k_, v_):
        return jnp.sum(JL.gqa_attention(q_, k_, v_, mask=mask)
                       * jnp.asarray(do))
    jgrads = jax.grad(attn, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in (q, k, v)))
    for g, want in zip(got, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL32)


@pytest.mark.parametrize("B,H,KV,S,T,dh,causal", FLASH_CASES[:4])
def test_plain_pieces_compose_from_the_forward_lse(B, H, KV, S, T, dh,
                                                   causal):
    """The three kernels' plain versions, fed the forward's output and
    log-sum-exp as the kernels are, give the whole backward; the lse is
    logsumexp of the masked scaled scores."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(B, H, KV, S, T, dh, 1))
    kw = dict(causal=causal)
    lse = ref.attention_lse(q, k, **kw)
    s = torch.einsum("bshd,bthd->bhst", q, torch.repeat_interleave(
        k, H // KV, dim=2)) / np.sqrt(dh)
    vis = torch.arange(T)[None, :] <= torch.arange(S)[:, None] + T - S
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(s.masked_fill(~vis, -np.inf),
                                     -1).numpy(), **TOL32)
    out = ref.mha_attention(q, k, v, **kw)
    delta = ref.flash_bwd_rowdot(out, do)
    assert delta.shape == (B, H, S)
    dk, dv = ref.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = ref.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    for got, want in zip((dq, dk, dv), ref.flash_attention_bwd(q, k, v, do,
                                                                 **kw)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL32)


def test_rows_without_a_key_have_no_gradient():
    """S > T causal: the first S - T query rows see no key. The kernels
    write zeros there (and +inf log-sum-exp); the plain backward gives
    those rows and their keys nothing."""
    q, k, v, do = (torch.tensor(a) for a in _inputs(1, 2, 1, 12, 5, 64))
    assert torch.isinf(ref.attention_lse(q, k)[:, :, :7]).all()
    dq, dk, dv = ref.flash_attention_bwd(q, k, v, do)
    assert torch.all(dq[:, :7] == 0)
    # the live rows alone give the same dk, dv
    dq2, dk2, dv2 = ref.flash_attention_bwd(q[:, 7:], k, v, do[:, 7:])
    np.testing.assert_allclose(dk.numpy(), dk2.numpy(), **TOL32)
    np.testing.assert_allclose(dv.numpy(), dv2.numpy(), **TOL32)
    np.testing.assert_allclose(dq[:, 7:].numpy(), dq2.numpy(), **TOL32)


def _emulate_kernels(monkeypatch):
    """Stand the four flash wrappers in with their plain versions on the
    wrappers' (B, head, position, dh) layouts, counting launches, and
    route ``ops`` to the kernel path on CPU tensors."""
    T = lambda x: x.transpose(1, 2)          # noqa: E731

    def fwd(q, k, v, *, causal=True, window=0, scale=None,
            return_lse=False):
        fwd.launches += 1
        assert not (torch.is_grad_enabled() and q.requires_grad)
        out = T(ref.mha_attention(T(q), T(k), T(v), causal=causal,
                                  window=window, scale=scale))
        return (out, ref.attention_lse(T(q), T(k), causal=causal,
                                       window=window, scale=scale)) \
            if return_lse else out

    def rowdot(out, dout):
        rowdot.launches += 1
        return ref.flash_bwd_rowdot(T(out), T(dout))

    def dkdv(q, k, v, dout, lse, delta, **kw):
        dkdv.launches += 1
        return tuple(T(t) for t in ref.flash_bwd_dkdv(
            T(q), T(k), T(v), T(dout), lse, delta, **kw))

    def dq(q, k, v, dout, lse, delta, **kw):
        dq.launches += 1
        return T(ref.flash_bwd_dq(T(q), T(k), T(v), T(dout), lse, delta,
                                  **kw))

    for f, name in ((fwd, "flash_attention"), (rowdot, "flash_bwd_rowdot"),
                    (dkdv, "flash_bwd_dkdv"), (dq, "flash_bwd_dq")):
        f.launches = 0
        monkeypatch.setattr(fa, name, f)
    monkeypatch.setattr(ops, "_plain", lambda impl, x: impl == "ref")
    return fwd, rowdot, dkdv, dq


def test_ops_flash_attention_differentiates_on_the_cpu():
    """On CPU tensors ``ops.flash_attention`` is the plain version, and
    autograd differentiates it."""
    q, k, v, do = _inputs(2, 8, 2, 16, 16, 64, 2)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ops.flash_attention(tq, tk, tv, causal=True).backward(torch.tensor(do))
    for t, w in zip((tq, tk, tv), _autograd_of_plain(q, k, v, do)):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), **TOL32)


@pytest.mark.parametrize("B,H,KV,S,T,dh,causal", [FLASH_CASES[1],
                                                  FLASH_CASES[3],
                                                  FLASH_CASES[5]])
def test_autograd_function_matches_autograd_of_plain(
        monkeypatch, B, H, KV, S, T, dh, causal):
    """The kernel route (``ops._FlashAttention``) with the four wrappers
    emulated by their plain versions: one forward launch with its
    log-sum-exp, one of each backward launch, and the gradients of
    autograd through ``ref.mha_attention``. Without grad the forward
    launches alone."""
    counters = _emulate_kernels(monkeypatch)
    q, k, v, do = _inputs(B, H, KV, S, T, dh, 3)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.shape == (B, S, H, dh) and out.grad_fn is not None
    # an upstream gradient in a layout the kernels do not take
    g = torch.tensor(do).transpose(0, 1).contiguous().transpose(0, 1)
    out.backward(g)
    assert [c.launches for c in counters] == [1, 1, 1, 1]
    for t, w in zip((tq, tk, tv), _autograd_of_plain(q, k, v, do,
                                                     causal=causal)):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), **TOL32)
    with torch.no_grad():
        ops.flash_attention(tq, tk, tv, causal=causal)
    assert [c.launches for c in counters] == [2, 1, 1, 1]


def test_autograd_function_under_remat_runs_the_forward_twice(monkeypatch):
    """Under ``layers.checkpointed`` (non-reentrant torch checkpoint) the
    block's forward, the flash kernel with it, runs again in the
    backward: two forward launches and one of each backward launch."""
    counters = _emulate_kernels(monkeypatch)
    q, k, v, do = _inputs(1, 4, 2, 16, 16, 64, 4)
    w = torch.tensor(np.eye(64, dtype=np.float32), requires_grad=True)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))

    def block(w_):
        return ops.flash_attention(tq @ w_, tk @ w_, tv, causal=True)
    L.checkpointed(block, w, remat=True).backward(torch.tensor(do))
    assert [c.launches for c in counters] == [2, 1, 1, 1]
    w2 = torch.tensor(np.eye(64, dtype=np.float32), requires_grad=True)
    block(w2).backward(torch.tensor(do))
    np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(), **TOL32)


def test_kernel_route_refuses_a_window_under_grad(monkeypatch):
    """The backward kernels take no window: the kernel route raises under
    grad with one, and runs the forward under ``torch.no_grad``."""
    counters = _emulate_kernels(monkeypatch)
    q, k, v, _ = (torch.tensor(a) for a in _inputs(1, 4, 2, 16, 16, 64, 5))
    with pytest.raises(ValueError, match="no window"):
        ops.flash_attention(q.requires_grad_(), k, v, window=4)
    with torch.no_grad():
        ops.flash_attention(q, k, v, window=4)
    assert [c.launches for c in counters] == [1, 0, 0, 0]


def test_refuse_grad_names_the_kernel():
    """The check every kernel wrapper without a backward runs first: an
    input that requires grad under grad mode raises, naming the kernel;
    ``torch.no_grad`` or inputs without grad pass."""
    from repro_torch.kernels import _build
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="grouped_mvm: an input requires "
                                           "grad"):
        _build.refuse_grad("grouped_mvm", torch.zeros(2), t)
    with torch.no_grad():
        _build.refuse_grad("grouped_mvm", t)
    _build.refuse_grad("grouped_mvm", torch.zeros(2), None)


def test_as_rows_copies_only_layouts_the_kernels_refuse():
    """``flash_attention.as_rows``, the layout rule the backward applies
    to an upstream gradient: a view with contiguous rows of 8-element
    strides on a 16-byte boundary passes as itself; a transposed last
    axis, a stride off the 8-element grain or a misaligned start is
    copied into contiguous rows, equal in value."""
    base = torch.arange(2 * 6 * 4 * 64, dtype=torch.float32).to(
        torch.bfloat16).view(2, 6, 4, 64)
    view = base.transpose(1, 2)
    assert fa.as_rows(view) is view
    flat_rows = base.view(-1, 64)
    for bad in (view.transpose(-1, -2), base.view(-1, 12)[:, :4],
                flat_rows[:, 1:9]):
        got = fa.as_rows(bad)
        assert got is not bad and got.is_contiguous()
        assert torch.equal(got, bad)


# --- MoE training: the load-balance loss, the grouped GEMM's backward -------------

def test_load_balance_loss_matches_reference():
    """``layers.load_balance_loss`` against the reference's
    ``_load_balance_loss`` on the same probabilities and top-k picks (ties
    among the picks included), within f32 rounding; and ``moe_ffn``'s
    ``return_aux`` gives it on the router's own probabilities without
    changing the output or the keep mask."""
    rng = np.random.default_rng(7)
    for N, E, K in ((32, 4, 2), (200, 64, 8), (9, 6, 1)):
        logits = rng.standard_normal((N, E)).astype(np.float32)
        logits[0] = 0.0                      # a token whose picks all tie
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        idx = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
        want = JL._load_balance_loss(jnp.asarray(probs), jnp.asarray(idx),
                                     JL.MoEDims(E, K, 4))
        got = L.load_balance_loss(torch.tensor(probs), torch.tensor(idx), E)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    cfg = get_config("olmoe-1b-7b").reduced()
    p = {k: v[0] for k, v in get_model(cfg).init_params(
        cfg, seed=0, device="cpu")["blocks"]["moe"].items()}
    x = torch.tensor(rng.standard_normal((24, cfg.d_model)),
                     dtype=torch.bfloat16)
    dims = L.moe_dims(cfg, 24)
    y, keep = L.moe_ffn(x, p, dims, return_keep=True)
    y2, keep2, aux = L.moe_ffn(x, p, dims, return_keep=True, return_aux=True)
    y3, aux3 = L.moe_ffn(x, p, dims, return_aux=True)
    assert torch.equal(y, y2) and torch.equal(y, y3)
    assert torch.equal(keep, keep2) and torch.equal(aux, aux3)
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    want = JL._load_balance_loss(
        jnp.asarray(probs.numpy()),
        jnp.asarray(torch.topk(probs, dims.top_k, dim=-1)[1].numpy()), dims)
    np.testing.assert_allclose(float(aux), float(want), rtol=1e-6)


def test_moe_loss_adds_the_averaged_load_balance_loss():
    """``moe.loss_fn`` is the mean cross-entropy plus ``aux_coef`` x the
    load-balance loss averaged over layers (``forward``'s ``return_aux``),
    as the reference's ``moe.loss_fn``; ``forward`` returns its extras in
    the reference's order (logits, aux, keeps)."""
    from repro_torch.models import moe
    jcfg, cfg, jp = _setup("deepseek-v2-lite-16b")
    view = compute_view(_master(jp))
    batch = {k: torch.tensor(v) for k, v in train_batch(cfg).items()}
    with torch.no_grad():
        logits, aux, keeps = moe.forward(cfg, view, batch, return_aux=True,
                                         return_route_keep=True)
        assert torch.equal(logits, moe.forward(cfg, view, batch))
        assert keeps.shape == (cfg.num_layers, 2, 16, cfg.moe.top_k)
        xent = torch.mean(L.softmax_xent(logits, batch["labels"]))
        for coef in (0.01, 0.5):
            np.testing.assert_allclose(
                float(moe.loss_fn(cfg, view, batch, aux_coef=coef)),
                float(xent + coef * aux), rtol=1e-6)
    jlogits, jaux = jget_model(jcfg).forward(
        jcfg, jp, {k: jnp.asarray(v) for k, v in train_batch(cfg).items()},
        return_aux=True)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-2)


# (E, C, D, F, rows): ragged rows with an expert that has none and a full
# one, C off any tile, all rows live (rows None)
GROUPED_CASES = [
    (4, 12, 16, 24, [0, 12, 5, 1]),
    (3, 60, 32, 8, [60, 0, 33]),
    (2, 7, 8, 16, None),
]


def _grouped_inputs(E, C, D, F, rows, seed=0):
    rng = np.random.default_rng(seed)
    x, w, dy = (rng.standard_normal(s).astype(np.float32)
                for s in ((E, C, D), (E, D, F), (E, C, F)))
    return x, w, dy, (None if rows is None
                      else torch.tensor(rows, dtype=torch.int32))


def _autograd_of_grouped(x, w, dy, rows, dtype=torch.float32):
    """(dx, dw) by torch autograd through ``ref.grouped_mvm``."""
    tx, tw = (torch.tensor(a).to(dtype).requires_grad_() for a in (x, w))
    ref.grouped_mvm(tx, tw, rows).backward(torch.tensor(dy).to(dtype))
    return tx.grad, tw.grad


@pytest.mark.parametrize("E,C,D,F,rows", GROUPED_CASES)
def test_grouped_backward_plain_is_the_gradient(E, C, D, F, rows):
    """``ref.grouped_mvm_bwd_dx`` / ``_dw`` (the kernels' formulas: f32
    products over the live rows, one rounding) against torch autograd
    through ``ref.grouped_mvm`` with the same ``rows``, in f32 within f32
    TOL and in bf16 bit for bit; against ``jax.grad`` of the reference's
    masked einsum; and dead rows of dX and the dW of an expert with no
    rows are zeros."""
    x, w, dy, tr = _grouped_inputs(E, C, D, F, rows)
    for dtype in (torch.float32, torch.bfloat16):
        tx, tw, tdy = (torch.tensor(a).to(dtype) for a in (x, w, dy))
        dx = ref.grouped_mvm_bwd_dx(tdy, tw, tr)
        dw = ref.grouped_mvm_bwd_dw(tx, tdy, tr)
        assert dx.dtype == dw.dtype == dtype
        want_dx, want_dw = _autograd_of_grouped(x, w, dy, tr, dtype)
        if dtype == torch.float32:
            np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), **TOL32)
            np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), **TOL32)
        else:
            assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
    live = np.full(E, C) if rows is None else np.asarray(rows)
    mask = (np.arange(C)[None, :] < live[:, None])[..., None]

    def masked(x_, w_):
        y = jnp.einsum("ecd,edf->ecf", x_, w_)
        return jnp.sum(jnp.where(mask, y, 0.0) * jnp.asarray(dy))
    jdx, jdw = jax.grad(masked, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
    dx = ref.grouped_mvm_bwd_dx(torch.tensor(dy), torch.tensor(w), tr)
    dw = ref.grouped_mvm_bwd_dw(torch.tensor(x), torch.tensor(dy), tr)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL32)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **TOL32)
    assert not dx.numpy()[~np.broadcast_to(mask, dx.shape)].any()
    assert not dw.numpy()[live == 0].any()


def _emulate_grouped(monkeypatch):
    """Stand the grouped GEMM's three wrappers in with their plain
    versions, counting launches and refusing grad as the wrappers do, and
    route ``ops`` to the kernel path on CPU tensors."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import grouped_mvm as gm

    def fwd(x, w, rows=None):
        _build.refuse_grad("grouped_mvm", x, w)
        fwd.launches += 1
        return ref.grouped_mvm(x, w, rows)

    def dx(dy, w, rows=None):
        _build.refuse_grad("grouped_mvm_bwd_dx", dy, w)
        assert dy.is_contiguous()
        dx.launches += 1
        return ref.grouped_mvm_bwd_dx(dy, w, rows)

    def dw(x, dy, rows=None):
        _build.refuse_grad("grouped_mvm_bwd_dw", x, dy)
        dw.launches += 1
        return ref.grouped_mvm_bwd_dw(x, dy, rows)

    for f, name in ((fwd, "grouped_mvm"), (dx, "grouped_mvm_bwd_dx"),
                    (dw, "grouped_mvm_bwd_dw")):
        f.launches = 0
        monkeypatch.setattr(gm, name, f)
    monkeypatch.setattr(ops, "_plain", lambda impl, x: impl == "ref")
    return fwd, dx, dw


@pytest.mark.parametrize("E,C,D,F,rows", GROUPED_CASES)
def test_grouped_autograd_function_matches_autograd_of_plain(
        monkeypatch, E, C, D, F, rows):
    """The kernel route (``ops._GroupedMVM``) with the three wrappers
    emulated by their plain versions: one forward launch, one dX and one
    dW launch, and the gradients of autograd through ``ref.grouped_mvm``
    (in f32 and in bf16); a launch is skipped for an input that needs no
    gradient, and without grad the forward launches alone."""
    counters = _emulate_grouped(monkeypatch)
    x, w, dy, tr = _grouped_inputs(E, C, D, F, rows, seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        before = [c.launches for c in counters]
        tx, tw = (torch.tensor(a).to(dtype).requires_grad_() for a in (x, w))
        out = ops.grouped_mvm(tx, tw, tr)
        assert out.grad_fn is not None and out.dtype == dtype
        # an upstream gradient in a layout the kernels do not take
        g = torch.tensor(dy).to(dtype).transpose(0, 1).contiguous() \
            .transpose(0, 1)
        out.backward(g)
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
        want_dx, want_dw = _autograd_of_grouped(x, w, dy, tr, dtype)
        assert torch.equal(tx.grad, want_dx) and torch.equal(tw.grad, want_dw)
    tx, tw = torch.tensor(x), torch.tensor(w).requires_grad_()
    ops.grouped_mvm(tx, tw, tr).backward(torch.tensor(dy))
    assert [c.launches for c in counters] == [3, 2, 3]
    with torch.no_grad():
        ops.grouped_mvm(tx, tw, tr)
    assert [c.launches for c in counters] == [4, 2, 3]


def test_moe_expert_ffn_differentiates_through_the_kernel_route(monkeypatch):
    """The SwiGLU of three grouped products under autograd on the kernel
    route: three forward launches, three dX and three dW, and the
    gradients of autograd through the plain products; under
    ``layers.checkpointed`` the forward launches once more."""
    counters = _emulate_grouped(monkeypatch)
    E, C, D, F = 3, 10, 16, 24
    rng = np.random.default_rng(2)
    xe, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) / 4
                      for s in ((E, C, D), (E, D, F), (E, D, F), (E, F, D)))
    rows = torch.tensor([10, 0, 4], dtype=torch.int32)
    dy = torch.tensor(rng.standard_normal((E, C, D)).astype(np.float32))

    def grads(impl, remat=False):
        ts = [torch.tensor(a).requires_grad_() for a in (xe, wg, wu, wd)]
        L.checkpointed(lambda *t: ops.moe_expert_ffn(*t, rows, impl=impl),
                       *ts, remat=remat).backward(dy)
        return [t.grad for t in ts]
    want = grads("ref")
    assert [c.launches for c in counters] == [0, 0, 0]
    for got in (grads("kernel"), grads("kernel", remat=True)):
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w_.numpy(), **TOL32)
    assert [c.launches for c in counters] == [9, 6, 6]


def test_moe_training_forward_launches_each_product_per_layer(monkeypatch):
    """A reduced MoE train step on the kernel route (the flash and grouped
    wrappers emulated): per layer three grouped forward launches, three
    more when remat recomputes the block, three dX and three dW; the
    recomputed blocks route as the first pass did, so remat gives the same
    loss and gradients."""
    counters = _emulate_grouped(monkeypatch)
    _emulate_kernels(monkeypatch)
    for arch in ("olmoe-1b-7b", "deepseek-v2-lite-16b"):
        _, cfg, jp = _setup(arch)
        batch = {k: torch.tensor(v)
                 for k, v in train_batch(cfg, seed=3).items()}
        out = {}
        for remat in (False, True):
            before = [c.launches for c in counters]
            params = _master(jp)
            flat_p = [t.requires_grad_() for t in flat(params).values()]
            loss = get_model(cfg).loss_fn(cfg, compute_view(params), batch,
                                          remat=remat)
            grads = torch.autograd.grad(loss, flat_p, allow_unused=True)
            n = cfg.num_layers
            assert [c.launches - b for c, b in zip(counters, before)] == \
                [3 * n * (1 + remat), 3 * n, 3 * n], arch
            out[remat] = (float(loss.detach()), grads)
        assert out[False][0] == out[True][0]
        for a, b in zip(out[False][1], out[True][1]):
            assert (a is None) == (b is None) and (a is None
                                                   or torch.equal(a, b))
