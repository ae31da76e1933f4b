"""drost.ladder_steps: mean over requests of log2(returned max_poses /
configured max_poses), the doublings of the top-K ladder (entry and
sizing, models/drost)."""

UNIT = "steps"


def read(run):
    if not run.records:
        return None
    return sum(r.outcome.ladder_steps for r in run.records) / len(run.records)
