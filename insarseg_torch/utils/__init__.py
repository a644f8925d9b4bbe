"""Training history files, step timers, the profiler trace and debugging
switches."""
