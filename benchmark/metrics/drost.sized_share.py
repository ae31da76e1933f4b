"""drost.sized_share: share of requests, in %, whose returned caps state is
not the one passed in, i.e. that fell back to the count pass (entry and
sizing, models/drost). Read where the traffic carries state."""

UNIT = "%"


def read(run):
    changed = [r.outcome.state_changed for r in run.records
               if r.outcome.state_changed is not None]
    if not changed:
        return None
    return 100.0 * sum(changed) / len(changed)
