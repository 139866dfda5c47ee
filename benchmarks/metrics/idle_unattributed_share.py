"""Share of the device's idle seconds in the traced window under no span
of the program's main thread (benchmarks/program.py:
idle_by_program_span): the idle time no program span explains."""
from benchmarks import program


def read(run):
    idle = run.device.get("idle_by_program")
    total = sum(idle.values()) if idle else 0.0
    if total <= 0:
        return None
    return idle[program.UNATTRIBUTED] / total
