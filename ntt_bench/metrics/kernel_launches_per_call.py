"""kernel_launches_per_call (kernels): the port's kernel launches a call, from
its launch counters (`LAUNCHES` of the kernel modules) as each top-level
span of the port records them. Nothing where the port records no spans."""

from ntt_bench import spans


def read(win):
    return spans.launches_per_call(win)
