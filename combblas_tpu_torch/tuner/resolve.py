"""Shared ``store > env > probe > heuristic`` tier resolution —
counterpart of ``combblas_tpu/tuner/resolve.py``.

``resolve_tier`` is the one walk of the precedence chain documented in
:mod:`~combblas_tpu_torch.tuner.config`, with the library's record
vetting (a key-matched record whose tier the op does not accept is
discarded and resolution degrades down the chain).  ``spgemm_auto`` and
``mesh3d.spgemm3d`` keep their own inlined walks (they interleave the
record's geometry, schedule and merge fills), with the same vetting.
"""

from __future__ import annotations

from .. import obs
from . import config
from . import store as tuner_store


def resolve_tier(
    key,
    *,
    allowed: tuple,
    heuristic,
    op: str = "spgemm",
    tier: str | None = None,
    store=None,
    probe=None,
    account: bool = True,
):
    """Resolve one tier through ``arg > store > env > probe >
    heuristic``.  Returns ``(tier, source, record)`` where ``source``
    names the winning rung (``arg`` / ``store`` / ``env`` / ``probe`` /
    ``heuristic``) and ``record`` is the vetted ``PlanRecord`` when the
    store or the probe won.

    * ``key`` — the :class:`~combblas_tpu_torch.tuner.store.PlanKey` to
      look up (``None`` skips the store rung);
    * ``allowed`` — tiers this op accepts; a key-matched record outside
      it is DISCARDED and resolution degrades down the chain;
    * ``heuristic`` — the fallback: a tier name, or a zero-arg callable
      evaluated only when every other rung passed;
    * ``probe`` — optional zero-arg callable returning a ``PlanRecord``
      (or None); tried only when probing is enabled
      (``COMBBLAS_TUNER_PROBE=1``) and the store missed;
    * ``account`` — ``True`` uses ``store.lookup`` (hit/miss counters)
      and counts ``spgemm.auto.plan_source`` and a vetted-out record's
      ``tuner.store.rejected``; ``False`` uses ``store.peek`` and counts
      nothing.
    """
    if tier is not None:
        source, rec = "arg", None
    else:
        source = rec = None
        if store is None:
            store = tuner_store.get_store()
        if store is not None and key is not None:
            rec = store.lookup(key) if account else store.peek(key)
        if rec is not None and rec.tier not in allowed:
            # the record vetting
            if account and obs.ENABLED:
                obs.count("tuner.store.rejected", reason="tier")
            rec = None
        if rec is not None:
            tier, source = rec.tier, "store"
        if tier is None:
            if op == "spgemm3d":
                env_val = config.env_tier3d()
            elif op == "spmm":
                env_val = config.env_spmm_backend()
            else:
                env_val = config.env_tier()
            if env_val is not None:
                tier, source = env_val, "env"
        if (
            tier is None
            and probe is not None
            and store is not None
            and config.probe_enabled()
        ):
            prec = probe()
            if prec is not None:
                tier, source, rec = prec.tier, "probe", prec
        if tier is None:
            tier = heuristic() if callable(heuristic) else heuristic
            source = "heuristic"
    if account and obs.ENABLED:
        obs.count("spgemm.auto.plan_source", source=source, tier=tier, op=op)
    return tier, source, rec


def resolve_merge(merge: str | None, rec):
    """Resolve the SpGEMM combine-merge tier through the top of the
    chain: ``arg > store record > env COMBBLAS_SPGEMM_MERGE``.  Returns
    ``(merge, source)`` — ``(None, None)`` when nothing above decided, in
    which case the sized entry runs its heuristic (it alone holds the L /
    collision estimate the heuristic needs).  A record's merge field is
    vetted at store load (``PlanRecord.from_json``).  An unknown ``merge``
    argument raises ``ValueError`` (the reference asserts)."""
    if merge is not None:
        if merge not in config.MERGE_TIER_NAMES:
            raise ValueError(
                f"merge must be one of {config.MERGE_TIER_NAMES}, got {merge!r}"
            )
        return merge, "arg"
    if rec is not None and rec.merge is not None:
        return rec.merge, "store"
    env_val = config.env_merge()
    if env_val is not None:
        return env_val, "env"
    return None, None
