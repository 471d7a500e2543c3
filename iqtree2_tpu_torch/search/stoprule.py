"""Search stopping rule.

Reference analog: StopRule (utils/stoprule.h:30) with conditions
SC_FIXED_ITERATION / SC_UNSUCCESS_ITERATION / SC_BOOTSTRAP_CORRELATION
(utils/tools.h:483). Defaults mirror A12: unsuccess_iteration=100,
max_iterations=1000.

Copied from iqtree2_tpu/search/stoprule.py: the port keeps its own host
modules and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StopRule:
    min_iterations: int = 100
    max_iterations: int = 1000
    unsuccess_iteration: int = 100
    fixed_iterations: int | None = None   # -n option
    use_correlation: bool = False         # UFBoot convergence mode

    last_improved: int = 0
    curIteration: int = 0

    def note_improvement(self, iteration: int) -> None:
        self.last_improved = iteration

    def should_stop(self, iteration: int,
                    correlation_converged: bool | None = None) -> bool:
        self.curIteration = iteration
        if self.fixed_iterations is not None:
            return iteration >= self.fixed_iterations
        if iteration >= self.max_iterations:
            return True
        if iteration < self.min_iterations:
            return False
        if self.use_correlation:
            if correlation_converged is None:
                return False
            # keep going in blocks of step_iterations until converged
            return correlation_converged and \
                iteration - self.last_improved >= self.unsuccess_iteration
        return iteration - self.last_improved >= self.unsuccess_iteration

    def earliest_stop(self, ufboot_step: int | None = None) -> int:
        """Smallest future iteration at which should_stop COULD return
        True given the current state (improvements only push it later).
        Batched search uses this to size each candidate batch so a stop
        never lands mid-batch — keeping the RNG draw sequence, and hence
        checkpoint resume, identical to the serial schedule."""
        if self.fixed_iterations is not None:
            return self.fixed_iterations
        bound = max(self.min_iterations,
                    self.last_improved + self.unsuccess_iteration)
        if self.use_correlation and ufboot_step:
            # correlation stops only at multiples of the UFBoot step
            b = -(-bound // ufboot_step) * ufboot_step
            bound = b
        return min(bound, self.max_iterations)
