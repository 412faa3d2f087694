"""Runtime invariant witnesses of the port.

Port of `pipeedge_tpu/analysis/`. `lockdep` is the opt-in (env
PIPEEDGE_LOCKDEP=1) lock-order witness behind `utils/threads.py`'s lock
factories. The AST rule engine (`lint` and the `rules_*` modules, run by
`tools/pipelint.py`) is not ported yet.

Stdlib-only by design: `utils/threads.py` imports `lockdep` at module
load, so nothing here may pull torch or any other piece of the runtime it
watches.
"""
