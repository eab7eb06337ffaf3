"""Injectable clocks (the server's deadline time base)."""
from .clock import FakeClock, MonotonicClock

__all__ = ["MonotonicClock", "FakeClock"]
