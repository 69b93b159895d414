"""ae_match_ms: host time per request in the port's ``ae.match`` span (the
wait for the candidate table's copy to the host and the Hungarian match
of every joint), read in the traced stretch that records the host's spans
alone."""

SPAN = "ae.match"


def read(ctx):
    if ctx.host_events is None:
        return None
    ns = [e.end - e.start for e in ctx.host_events
          if e.cat == "user_annotation" and e.name == SPAN]
    return sum(ns) / ctx.requests_traced * 1e-6 if ns else None
