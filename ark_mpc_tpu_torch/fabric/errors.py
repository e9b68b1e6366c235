"""Error types (`online-phase/src/error.rs:8-66` analog)."""


class MpcError(Exception):
    """Base error for the online phase."""


class NetworkError(MpcError):
    """Transport failure (`MpcError::NetworkError`)."""


class AuthenticationError(MpcError):
    """MAC check / commitment verification failed — malicious behavior
    detected (`MpcError::AuthenticationError`). The computation must abort."""


class VisibilityError(MpcError):
    """A value was used with the wrong visibility."""


class ArithmeticError(MpcError):
    """Invalid arithmetic (e.g. inverting zero where disallowed)."""


class SetupError(MpcError):
    """Connection / setup failure (`SetupError` analog)."""
