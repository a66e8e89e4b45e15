"""Tensor and chunk state machine (PatrickStar Table 1 / Fig. 7).

Every model-data tensor managed by PatrickStar carries a state that
determines where the chunk containing it may legally live:

  FREE            no payload space is held for this tensor.
  COMPUTE         the tensor is about to be / being used by an operator and
                  must be resident on the *computing device*.
  HOLD            payload must be kept, but may live on either tier.
  HOLD_AFTER_FWD  HOLD produced by releasing a tensor after forward.
  HOLD_AFTER_BWD  HOLD produced by releasing a tensor after backward.
  RELEASED        multi-process only (Section 7): the tensor lives in a
                  chunk owned by a *remote* rank; the local replica's
                  payload has been dropped and the authoritative value is
                  the owner's.  A chunk-granular all-gather re-materializes
                  the whole communication group (RELEASED -> HOLD) before
                  any of its tensors may enter COMPUTE.

The HOLD/HOLD_AFTER_* three are collectively "HOLD-like".  Distinguishing
the after-FWD/after-BWD variants is what lets the distributed runtime
decide when a whole communication group has finished a phase
(Algorithm 2), even in the presence of activation checkpointing, which
re-runs forward computation *during* backward.  RELEASED differs from
FREE in exactly one way that matters: a FREE tensor's first access
zero-fills (Algorithm 1 line 31), while a RELEASED tensor's first access
must FETCH the owner's bytes — zero-filling a remote parameter would
corrupt the model.

The **activation stream** (the fifth managed stream) reuses this same
machine with a strictly simpler trajectory — each checkpointed layer
input is written once during FWD, read once during BWD at the mirrored
layer index, then dropped:

    FREE -> COMPUTE (FWD write) -> HOLD_AFTER_FWD
         -> COMPUTE (BWD read)  -> FREE (payload released)

No act tensor ever enters RELEASED (activations are rank-local: there is
no remote owner to fetch from) and none survives the step, so the act
stream needs no new states or transitions — only the FREE<->COMPUTE and
HOLD_AFTER_FWD->COMPUTE edges that already exist.
"""

from __future__ import annotations

import enum
from typing import Iterable


class TensorState(enum.Enum):
    FREE = "FREE"
    COMPUTE = "COMPUTE"
    HOLD = "HOLD"
    HOLD_AFTER_FWD = "HOLD_AFTER_FWD"
    HOLD_AFTER_BWD = "HOLD_AFTER_BWD"
    RELEASED = "RELEASED"

    @property
    def is_hold_like(self) -> bool:
        return self in _HOLD_LIKE

    @property
    def is_payload_free(self) -> bool:
        """States in which the tensor holds no local payload bytes."""
        return self is TensorState.FREE or self is TensorState.RELEASED

    def __repr__(self) -> str:  # compact in logs
        return self.value


_HOLD_LIKE = frozenset(
    {TensorState.HOLD, TensorState.HOLD_AFTER_FWD, TensorState.HOLD_AFTER_BWD}
)

# Legal transitions of a param-fp16 tensor, following Fig. 7 of the paper.
# (init) -> HOLD -> COMPUTE -> HOLD_AFTER_FWD -> HOLD (reset before BWD)
#        -> COMPUTE -> HOLD_AFTER_BWD -> (grad overwrites payload) ... -> HOLD
# FREE is entered when a chunk's payload is dropped, and left when the
# chunk re-materializes it.  RELEASED is the remote-chunk lifecycle
# (Section 7 / Algorithm 1-2): entered at init for non-owned chunks and
# again when a communication group finishes its post-FWD/post-BWD
# transition; left only through the all-gather that re-materializes the
# group (-> HOLD, or directly -> COMPUTE for the accessed tensor).
_LEGAL_TRANSITIONS: dict[TensorState, frozenset[TensorState]] = {
    TensorState.FREE: frozenset(
        {TensorState.HOLD, TensorState.COMPUTE, TensorState.RELEASED}
    ),
    TensorState.HOLD: frozenset(
        {TensorState.COMPUTE, TensorState.FREE, TensorState.HOLD, TensorState.RELEASED}
    ),
    TensorState.COMPUTE: frozenset(
        {
            TensorState.HOLD,
            TensorState.HOLD_AFTER_FWD,
            TensorState.HOLD_AFTER_BWD,
            TensorState.FREE,
        }
    ),
    TensorState.HOLD_AFTER_FWD: frozenset(
        {TensorState.COMPUTE, TensorState.HOLD, TensorState.FREE, TensorState.RELEASED}
    ),
    TensorState.HOLD_AFTER_BWD: frozenset(
        {TensorState.COMPUTE, TensorState.HOLD, TensorState.FREE, TensorState.RELEASED}
    ),
    TensorState.RELEASED: frozenset({TensorState.HOLD, TensorState.COMPUTE}),
}


class IllegalTransition(RuntimeError):
    """Raised when a tensor attempts a transition Fig. 7 does not permit."""


def check_transition(old: TensorState, new: TensorState) -> None:
    if new not in _LEGAL_TRANSITIONS[old]:
        raise IllegalTransition(f"illegal tensor state transition {old!r} -> {new!r}")


class ChunkState(enum.Enum):
    """Derived location constraint of a chunk (Sections 6.2, 7).

    FREE      all tensors FREE: the payload may be reused or released.
    COMPUTE   >=1 tensor COMPUTE: chunk must be on the computing device.
    HOLD      otherwise (>=1 HOLD-like, none COMPUTE): may live on any tier.
    RELEASED  no COMPUTE/HOLD-like tensor but >=1 RELEASED: the chunk is a
              remote rank's; no local payload, re-enters HOLD by all-gather.
    """

    FREE = "FREE"
    COMPUTE = "COMPUTE"
    HOLD = "HOLD"
    RELEASED = "RELEASED"


def derive_chunk_state(tensor_states: Iterable[TensorState]) -> ChunkState:
    saw_any = False
    saw_hold = False
    saw_released = False
    for s in tensor_states:
        saw_any = True
        if s is TensorState.COMPUTE:
            return ChunkState.COMPUTE
        if s.is_hold_like:
            saw_hold = True
        elif s is TensorState.RELEASED:
            saw_released = True
    if saw_hold:
        return ChunkState.HOLD
    if saw_released:
        return ChunkState.RELEASED
    return ChunkState.FREE


def all_in(states: Iterable[TensorState], target: TensorState) -> bool:
    return all(s is target for s in states)
