"""The failure types of the serving stack (the part of
``repro.serve.faults`` that the executor needs).

``FaultError`` and its subclasses are the failures a router survives
(retry on another replica, quarantine, shed); anything else escaping a
wave is a bug and propagates. ``WaveError`` wraps an execution failure
inside ``CompiledTinyModel.submit_wave`` so that a raw backend exception
never escapes the serving entry point untyped. The fault plans, the
injector and the integrity guard come with the serving slice.
"""

from __future__ import annotations


class FaultError(RuntimeError):
    """Base of the failures the router survives (retry/quarantine/shed).

    Subclassing ``RuntimeError`` keeps ``except RuntimeError`` callers
    working; a router catches ``FaultError`` so that unexpected exceptions
    (genuine bugs) still propagate loudly.
    """


class WaveError(FaultError):
    """A wave failed inside the executor: the typed wrapper around any
    backend/runtime exception escaping ``submit_wave`` execution (the
    input-validation ``ValueError``s are *not* wrapped — a malformed wave
    is a caller bug, not a device failure)."""
