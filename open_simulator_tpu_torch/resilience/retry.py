"""Retry-with-backoff around flaky device execution: the reference's
``resilience/retry.py``.

A bounded exponential backoff turns transient device failures into
latency instead of failures; persistent errors still propagate after the
attempts are exhausted so real bugs surface.

**What counts as retryable** is the device fault classifier's call
(``resilience/faults.py``): by default only *transient*-classed faults
(transfer trouble, bare OSErrors) retry, and a deterministic-classed
error — an OOM, a NaN, a compile failure, a plain program bug — is
re-raised on attempt 0. Callers may pass an exception-class tuple or
their own predicate.

Two knobs harden the schedule for fleet use:

* **full jitter** (``jitter=True``): each sleep is drawn uniformly from
  ``[0, backoff_s * 2^attempt]`` (capped), so a fleet of workers that
  hit the same transient at the same instant do not retry in lockstep;
* **max_elapsed_s**: a wall-clock cap on the whole retry loop.

The reference also counts each outcome in ``simon_retry_total{outcome}``;
the port has no telemetry counters yet (ROADMAP queue 1, item 11) and
counts nothing.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar, Union

T = TypeVar("T")

RetryOn = Union[Tuple[Type[BaseException], ...],
                Callable[[BaseException], bool]]


def backoff_delay(attempt: int, backoff_s: float, max_backoff_s: float,
                  jitter: bool = False,
                  rng: Optional[random.Random] = None) -> float:
    """The sleep before retry number ``attempt`` (0-based): exponential
    ``backoff_s * 2^attempt`` capped at ``max_backoff_s``; with
    ``jitter``, drawn uniformly from ``[0, capped]`` (AWS "full jitter").
    Pure given ``rng`` — unit-testable with a seeded generator."""
    capped = min(backoff_s * (2.0 ** attempt), max_backoff_s)
    if not jitter or capped <= 0.0:
        return capped
    return (rng or random).uniform(0.0, capped)


def _retry_predicate(retry_on: Optional[RetryOn]
                     ) -> Callable[[BaseException], bool]:
    """Normalize ``retry_on`` to a predicate. ``None`` (the default)
    resolves to the device-fault classifier's transient test — the
    replacement for the deprecated retry-everything tuple."""
    if retry_on is None:
        from open_simulator_tpu_torch.resilience.faults import is_transient

        return is_transient
    if isinstance(retry_on, type):
        # a bare exception class (the old `except retry_on:` form took
        # one): treat as a one-class tuple — falling through to the
        # predicate branch would CALL the class, constructing a truthy
        # instance, and silently retry everything
        retry_on = (retry_on,)
    if isinstance(retry_on, tuple):
        return lambda e: isinstance(e, retry_on)
    return retry_on


def run_with_retries(
    fn: Callable[[], T],
    retries: int = 2,
    backoff_s: float = 0.05,
    max_backoff_s: float = 2.0,
    max_elapsed_s: Optional[float] = None,
    jitter: bool = False,
    rng: Optional[random.Random] = None,
    retry_on: Optional[RetryOn] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call fn(); on a retryable exception wait ``backoff_delay(attempt)``
    and try again, up to ``retries`` extra attempts. The last failure is
    re-raised unchanged; non-retryable exceptions re-raise on attempt 0.

    ``retry_on`` is an exception-class tuple, a predicate
    ``(exc) -> bool``, or None (default) for the device-fault
    classifier's transient test (``faults.is_transient``) — the old
    ``(Exception,)`` retry-everything default is deprecated because it
    spent the backoff budget reproducing deterministic failures.

    ``max_elapsed_s`` caps the loop in wall-clock terms: once the elapsed
    time plus the NEXT planned sleep would exceed it, the loop stops
    retrying and re-raises — attempts remaining or not. (Checked before
    sleeping, so the cap is never overshot by a full backoff.)"""
    should_retry = _retry_predicate(retry_on)
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — the predicate decides
            if not should_retry(e):
                raise
            if attempt >= retries:
                raise
            delay = backoff_delay(attempt, backoff_s, max_backoff_s,
                                  jitter=jitter, rng=rng)
            if max_elapsed_s is not None and (
                    time.monotonic() - t0) + delay > max_elapsed_s:
                raise
            sleep(delay)
            attempt += 1
