"""A kernel's bytes and operations a call, from its launch's shape: one
module a kernel, found by the kernel's short name (k1, k2, ...).  Each
names the C entry point that launches it, how the entry's arguments give
the shape, and the device kernel's name in the profiler's trace."""
