"""The port's Engine against the JAX Engine under per-step dispatch and
under prefix sharing with copy-on-write, and the port's fused horizon
against its own per-step dispatch (see _torch_parity for the standard)."""

from _torch_parity import assert_engines_agree, run_port, setup, traces

PREEMPTING = dict(n_requests=8, mean_interarrival=0.2, prompt_lens=(8, 16),
                  gen_lens=(24, 40), seed=1)
TINY_POOL = dict(num_slots=4, page_size=8, num_pages=17, max_pages_per_seq=8,
                 prefill_bucket=8)


def test_engine_per_step_matches_jax_engine():
    """horizon=1: one dispatch, one sync and one full-table upload per
    decode step in both engines."""
    _, trep = assert_engines_agree("poisson_trace", PREEMPTING, horizon=1,
                                   **TINY_POOL)
    assert trep.host_syncs == trep.decode_steps
    assert trep.page_table_upload_bytes == trep.decode_steps * 4 * 8 * 4


def test_engine_prefix_sharing_cow_matches_jax_engine():
    """Tight pool and verbatim re-sends: shared-page admission, index
    eviction, preemption and copy-on-write all fire, with equal ledgers."""
    _, trep = assert_engines_agree(
        "shared_prefix_trace",
        dict(n_requests=16, overlap=0.5, prompt_len=32,
             mean_interarrival=0.25, gen_lens=(24,), seed=11,
             resend_frac=0.5),
        num_slots=8, page_size=8, num_pages=21, max_pages_per_seq=16,
        prefill_bucket=8, prefix_sharing=True)
    assert trep.cow_copies > 0 and trep.shared_page_hits > 0
    assert trep.preemptions > 0 and trep.prefill_tokens_saved > 0


def test_fused_horizon_matches_per_step_in_the_port():
    """Fusion changes how many dispatches the schedule costs, never the
    schedule or the tokens."""
    _, _, cfg, tp = setup()
    _, trace = traces("poisson_trace", vocab_size=cfg.vocab_size,
                      **PREEMPTING)
    fused = run_port(cfg, tp, trace, horizon=32, **TINY_POOL)
    step = run_port(cfg, tp, trace, horizon=1, **TINY_POOL)
    assert {r.rid: r.generated for r in fused.completed} == \
        {r.rid: r.generated for r in step.completed}
    assert {r.rid: (r.admitted_step, r.done_step) for r in fused.completed} \
        == {r.rid: (r.admitted_step, r.done_step) for r in step.completed}
    assert fused.device_dispatches < step.device_dispatches
    assert fused.host_syncs < step.host_syncs
