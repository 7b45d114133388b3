"""Rule registry: one module per RL rule; ``ALL_RULES`` is what the
linter (repro_torch.analysis.lint) runs.

The port carries the reference's rules whose contract exists in an eager
PyTorch package:

  RL002  no host sync in serve-path code (rl002_host_sync);
  RL004  collective axis names declared in sharding/rules.py
         (rl004_psum_axes);
  RL005  grid and page arithmetic that cannot truncate, and no kernel
         launch before its argument check (rl005_pallas_blocks).

Not ported, because their contract has no counterpart here:
  RL001  (``jit`` ``static_argnames`` naming real parameters, no branch on
         closed-over values): the port compiles nothing, so there are no
         static arguments and a branch on a captured value is re-read on
         every eager call;
  RL003  (pytree registration drift): the port has no pytrees; its plans
         and stats are plain dataclasses of tensors that nothing flattens.

Adding a rule: create ``rlNNN_<slug>.py`` here exporting ``RULE_ID``,
``SUMMARY`` and ``check(mod: astutil.ModuleInfo) -> list[Finding]``,
append it to ``ALL_RULES``, and give it an injected-violation test in
tests/test_torch_analysis.py (every rule must be shown able to fail).
"""
from repro_torch.analysis.rules import (rl002_host_sync, rl004_psum_axes,
                                        rl005_pallas_blocks)

ALL_RULES = (rl002_host_sync, rl004_psum_axes, rl005_pallas_blocks)

RULE_IDS = tuple(r.RULE_ID for r in ALL_RULES)
