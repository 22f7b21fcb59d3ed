"""Device idle time under the self time of the zoom line search (the
program's ``linesearch`` and ``linesearch.trial`` spans, and the trials'
``host_read`` flag reads), its objective left out, over the traced window,
in percent."""

from benchmark import spans

SEARCH = ("linesearch", "linesearch.trial")


def read(run):
    joined = spans.joined(run) if run.unit == "iter" else None
    if joined is None or not joined.indices("linesearch"):
        return None
    names, parents = joined.names, joined.parents

    def search(i):
        return names[i] in SEARCH or (
            names[i] == "host_read" and parents[i] is not None
            and names[parents[i]] in SEARCH)

    return joined.idle_pct(search)
