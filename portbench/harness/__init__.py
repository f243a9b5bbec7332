"""The benchmark's yardstick: the case generator, the spans and the
profile's reduction, the kernels' byte arithmetic, the judge, and what
the channel's entries share."""


class RunError(RuntimeError):
    """A run that cannot give a result."""
