"""Shared harness of the port's engine tests: the JAX ``Engine`` and the
port's ``Engine`` on one seeded trace, reduced config, converted weights.

Requests end by token budget, so the schedule does not depend on token
values: the ledger (admission and done steps, preemptions, pages,
prefill tokens, dispatch/sync/upload counts) must match exactly. Token
streams must be equal or, where they differ, teacher-forced greedy-
consistent at bf16 (README "Prefix sharing", *Numerics*): every token the
port chose sits within a few bf16 quanta of the argmax of the
reference's clean full-sequence forward at that position.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.runtime import Engine as JEngine
from repro.runtime import EngineConfig as JEngineConfig
from repro.runtime import scheduler as jsched
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.runtime import Engine, EngineConfig
from repro_torch.runtime import scheduler as tsched

REPORT_FIELDS = (
    "decode_steps", "slot_steps", "useful_slot_steps", "prefill_calls",
    "prefill_tokens", "preemptions", "peak_live_pages", "shared_page_hits",
    "cow_copies", "prefill_tokens_saved", "peak_demand_pages", "page_bytes",
    "cache_bytes_alloc", "device_dispatches", "host_syncs",
    "page_table_upload_bytes", "new_tokens")
REQUEST_FIELDS = ("rid", "arrival", "admitted_step", "done_step", "prefills",
                  "truncated", "shared_pages", "cow_copies")
# the reference's own churn bound (test_runtime.py): 0.0625 in logits of
# order 1-4 is a few bf16 quanta; KV corruption shows as O(1) gaps
GREEDY_GAP = 0.0625


def setup(arch="codeqwen1.5-7b", seed=0):
    jcfg = jget(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = get_config(arch).reduced()
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def run_port(cfg, params, trace, **ecfg):
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny CPU ops: no thread-pool contention
    try:
        return Engine(cfg, params, EngineConfig(**ecfg)).run(
            copy.deepcopy(trace))
    finally:
        torch.set_num_threads(n)


def ledger(rep) -> dict:
    out = {f: getattr(rep, f) for f in REPORT_FIELDS}
    out["requests"] = sorted(tuple(getattr(r, f) for f in REQUEST_FIELDS)
                             for r in rep.completed)
    return out


def greedy_gap(jcfg, jp, req) -> float:
    """Largest gap between the reference forward's max logit and the logit
    of the token ``req`` generated, over its generated positions."""
    seq = jnp.asarray([list(req.prompt) + list(req.generated)], jnp.int32)
    logits = np.asarray(JT.forward(jcfg, jp, {"tokens": seq})[0], np.float64)
    start = len(req.prompt)
    return max(float(logits[start + i - 1].max() - logits[start + i - 1][t])
               for i, t in enumerate(req.generated))


def traces(kind: str, **kw):
    """The same seeded trace from both packages' trace generators
    (``kind`` names the generator, e.g. "poisson_trace")."""
    return getattr(jsched, kind)(**kw), getattr(tsched, kind)(**kw)


def assert_engines_agree(trace_kind: str, trace_kw: dict, *,
                         arch="codeqwen1.5-7b", **ecfg):
    """Run both engines on one seeded trace, each built by its own
    package; return (jax report, port report)."""
    jcfg, jp, cfg, tp = setup(arch)
    jtrace, ttrace = traces(trace_kind, vocab_size=cfg.vocab_size,
                            **trace_kw)
    jrep = JEngine(jcfg, jp, JEngineConfig(**ecfg)).run(jtrace)
    trep = run_port(cfg, tp, ttrace, **ecfg)
    assert ledger(trep) == ledger(jrep)
    jtok = {r.rid: r.generated for r in jrep.completed}
    for r in trep.completed:
        if r.generated != jtok[r.rid]:
            gap = greedy_gap(jcfg, jp, r)
            assert gap <= GREEDY_GAP, (r.rid, gap)
    return jrep, trep
