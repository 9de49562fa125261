"""The port's batched runner (``dpgo_tpu_torch.serve.run_bucket``) against
the JAX package's on the CPU in float64: each member of a mixed batch at
every schedule, per-eval and verdict, equals the JAX package's member at
rtol 1e-9, and the port's verdict batch equals its per-eval batch with
``==`` (``test_torch_serve.py`` states the tolerances).  A file of its
own, apart from ``test_torch_serve.py``'s other checks, so that the test
runner's workers (``--dist loadfile``) take these long cases apart from
those.
"""

import pytest

from dpgo_tpu.serve import cache as jcache
from dpgo_tpu.serve import runner as jrunner
from dpgo_tpu_torch.serve import ExecutableCache, run_bucket

# one_thread: test_torch_serve.py's autouse fixture, applied here too.
from test_torch_serve import (EVAL_EVERY, K, MAX_ITERS, SCHEDULES,  # noqa: F401
                              _assert_results, _both_params, _mixed_batch,
                              _replay_async, one_thread)


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_run_bucket_members_match_jax(case, monkeypatch):
    """Each member of a mixed batch, per-eval and verdict, equals the JAX
    package's ``run_bucket`` member: iterations, reason, histories, the
    rounded trajectory, the iterate and the weights (rtol 1e-9); the
    port's verdict batch equals its per-eval batch bit for bit."""
    jp, tp = _both_params(SCHEDULES[case])
    _replay_async(monkeypatch, SCHEDULES[case], MAX_ITERS + K)
    jpad, tpad = _mixed_batch(jp, tp)
    out = {}
    for ve in (None, K):
        jres, jinfo = jrunner.run_bucket(
            jpad, jcache.ExecutableCache(), max_iters=MAX_ITERS,
            grad_norm_tol=1e-12, eval_every=EVAL_EVERY, verdict_every=ve)
        tres, tinfo = run_bucket(
            tpad, ExecutableCache(), max_iters=MAX_ITERS,
            grad_norm_tol=1e-12, eval_every=EVAL_EVERY, verdict_every=ve)
        assert (tinfo["rounds"], tinfo["batch"], tinfo["size"]) == \
            (jinfo["rounds"], jinfo["batch"], jinfo["size"]) == \
            (MAX_ITERS, 4, 3)
        for a, b in zip(tres, jres):
            _assert_results(a, b)
        out[ve] = tres
    for a, b in zip(out[None], out[K]):
        _assert_results(a, b, exact=True)
