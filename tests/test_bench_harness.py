"""The bench harness itself must survive a hung stage.

The harness runs each stage in its own subprocess with the watchdog in
the parent and ONE retry per stage. These tests simulate a hang (a
child that sleeps forever exactly where a real stage would block) and
assert the yield contract:

  * a stage that hangs once and recovers on retry still lands its
    metric in the cumulative line;
  * a stage that hangs twice is recorded as an error WITHOUT erasing
    the other stages' metrics, and the bench exits non-zero;
  * the last stdout line always parses as the cumulative JSON.

Reference posture analog: App.cpp:642-670 in the reference (the
swapchain recreate loop retries, then continues the frame loop).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")


def _run_parent(extra_env, timeout=120):
    env = dict(os.environ)
    env.update(
        {
            "BENCH_FAKE_RESULT": "1",
            "BENCH_CHILD_TIMEOUT_S": "4",
            "BENCH_PARENT_TIMEOUT_S": "8",
            "BENCH_RETRY_PAUSE_S": "0",
        }
    )
    env.update(extra_env)
    out = subprocess.run(
        [sys.executable, BENCH],
        capture_output=True,
        text=True,
        env=env,
        timeout=timeout,
    )
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert lines, f"no stdout from parent (stderr: {out.stderr[-500:]})"
    final = json.loads(lines[-1])
    return out, final


def test_clean_run_merges_all_stages():
    out, final = _run_parent({})
    assert out.returncode == 0
    assert final["value"] == 1.0
    assert final["baseline_mrays"] == 60.0
    assert final["deferred_ms"] == 1.0
    assert final["restir_ms"] == 2.0
    assert final["errors"] == {}
    # every intermediate line parses too (the cumulative-snapshot contract)
    for line in out.stdout.splitlines():
        if line.strip():
            json.loads(line)


def test_wedge_once_recovers_on_retry():
    # pt wedges on attempt 1 only; the child watchdog (4s) fires first,
    # the parent retries, attempt 2 returns the canned result.
    out, final = _run_parent({"BENCH_SIMULATE_WEDGE": "pt:1"})
    assert final["value"] == 1.0, final
    assert "pt" not in final["errors"], final["errors"]
    assert "pt_attempt1" in final["errors"]  # legibility: the wedge is recorded
    assert "wedged" in final["errors"]["pt_attempt1"]
    # the other stages are untouched, and the recovered run passes
    assert final["deferred_ms"] == 1.0 and final["restir_ms"] == 2.0
    assert out.returncode == 0


def test_wedge_twice_records_error_without_erasing_other_stages():
    # pt hangs on BOTH attempts: its metric is lost, everything else
    # still lands, and the failed stage fails the bench
    out, final = _run_parent({"BENCH_SIMULATE_WEDGE": "pt"})
    assert final["value"] is None
    assert "pt" in final["errors"] and "wedged" in final["errors"]["pt"]
    assert final["deferred_ms"] == 1.0 and final["restir_ms"] == 2.0
    assert out.returncode != 0


def test_budget_follows_live_ray_count():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench", BENCH)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert bench.budget_mrays(2_000_000) == 60.0
    assert bench.budget_mrays(4_000_000) == 2 * bench.budget_mrays(2_000_000)


def test_parent_watchdog_kills_child_that_outlives_its_own_watchdog():
    # Child watchdog effectively disabled (huge bound): the PARENT's
    # timeout must kill the wedged child and still retry.
    out, final = _run_parent(
        {
            "BENCH_SIMULATE_WEDGE": "deferred:1",
            "BENCH_CHILD_TIMEOUT_S": "9999",
            "BENCH_PARENT_TIMEOUT_S": "4",
        }
    )
    assert final["deferred_ms"] == 1.0, final
    assert "deferred_attempt1" in final["errors"]
    assert "parent watchdog" in final["errors"]["deferred_attempt1"]
