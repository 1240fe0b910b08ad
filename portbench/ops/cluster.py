"""A clustering from scratch: the host's float32 points in, ``make_engine``
(plan and build), ``dbscan``, the labels copied to the host.

Traffic key: ``engine`` (absent: ``grid``, the program's default), the
engine ``make_engine`` builds."""
from portbench.harness import Output


def setup(ctx) -> None:
    pass


def call(ctx, job, span) -> Output:
    from repro_torch.core.dbscan import dbscan
    from repro_torch.core.engines import make_engine

    pts = ctx.pool[job.dataset]
    with span("make_engine"):
        eng = make_engine(pts, job.eps, device=ctx.device,
                          engine=ctx.traffic.get("engine", "grid"))
    with span("dbscan"):
        res = dbscan(pts, job.eps, job.min_pts, eng=eng)
    with span("labels_to_host"):
        labels = res.labels.cpu()
    return Output(res.counts, res.core, labels, res.timings,
                  dict(eng.timings), res.n_rounds)
