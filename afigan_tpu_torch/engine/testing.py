"""Result verification against ``TEST.EXPECTED_RESULTS`` (counterpart of
``afigan_tpu/engine/testing.py``; numpy only).

``TEST.EXPECTED_RESULTS`` is a list of ``[task, metric, expected,
tolerance]`` rows, each checked against the eval-results dict
``{task: {metric: value}}``. A final-eval mismatch raises; periodic
mid-training evals pass ``raise_on_failure=False`` and only log.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

logger = logging.getLogger(__name__)


def verify_results(cfg, results: Dict[str, Dict[str, float]],
                   raise_on_failure: bool = True) -> bool:
    """Check ``results`` against ``cfg.TEST.EXPECTED_RESULTS``.

    Returns True when there is nothing to verify or every row passes; on
    failure raises ``RuntimeError`` listing every failed row when
    ``raise_on_failure``, else logs the failures and returns False."""
    expected = cfg.TEST.EXPECTED_RESULTS
    if not expected:
        return True
    failures = []
    for row in expected:
        task, metric, target, tolerance = row
        try:
            actual = results[task][metric]
        except KeyError:
            failures.append(f"{task}/{metric}: missing from results "
                            f"(have tasks {sorted(results)})")
            continue
        ok = np.isfinite(actual) and abs(actual - float(target)) <= float(tolerance)
        logger.info(f"verify_results {task}/{metric}: actual={actual:.4f} "
                    f"expected={float(target):.4f} tol={float(tolerance):.4f} -> "
                    f"{'passed' if ok else 'FAILED'}")
        if not ok:
            failures.append(f"{task}/{metric}: actual={actual:.4f} "
                            f"expected={float(target):.4f} tolerance={float(tolerance):.4f}")
    if failures:
        msg = "TEST.EXPECTED_RESULTS verification failed:\n  " + "\n  ".join(failures)
        if raise_on_failure:
            raise RuntimeError(msg)
        logger.error(msg)
        return False
    logger.info(f"verify_results: all {len(expected)} expectation(s) passed")
    return True
