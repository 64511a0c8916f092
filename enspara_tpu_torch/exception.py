"""Framework-wide exception and warning types.

Mirrors the public error vocabulary of the reference
(enspara/exception.py:5-40) so user code can catch the same categories:
configuration errors, invalid data, and insufficient host/device resources.
"""


class EnsparaTPUError(Exception):
    """Base class for all framework errors."""


class ImproperlyConfigured(EnsparaTPUError):
    """The function or object was configured incorrectly (bad or
    inconsistent arguments, missing required options)."""


class DataInvalid(EnsparaTPUError):
    """The data given to the function doesn't satisfy its contract
    (shape mismatches, ragged inconsistencies, bad dtypes)."""


class InsufficientResourceError(EnsparaTPUError):
    """Not enough host RAM / device HBM / devices to run the request."""


class ConvergenceWarning(UserWarning):
    """An iterative estimator stopped before reaching its tolerance."""


class PerformanceWarning(UserWarning):
    """Something will work, but on a slow path (e.g. host fallback
    instead of a device kernel)."""


class SuspiciousDataWarning(UserWarning):
    """Input data looks odd (e.g. all-identical frames, NaNs)."""


class MissingData(EnsparaTPUError):
    """Expected data (file, key, field) was absent."""
