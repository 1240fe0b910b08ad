"""A re-run on an engine built at set-up, the paper's §VI-B workflow:
``dbscan(points, ε, minPts, eng=...)``, the labels copied to the host.
The plan and the build are bypassed.

Traffic keys: ``engine`` as in ``cluster``; ``saved_counts`` (absent:
false): stage 1's counts are worked out once a (dataset, ε) at set-up
and handed to every call (``precomputed_counts``), so a call runs stage
2 and the border only; stage 1's span then holds no sweep, and
``stage1_roofline`` does not apply to such a mix."""
from portbench.harness import Output, schedule


def setup(ctx) -> None:
    from repro_torch.core.dbscan import dbscan
    from repro_torch.core.engines import make_engine

    for k, eps in sorted({(k, e) for k, e, _ in schedule(ctx.config,
                                                          ctx.traffic)}):
        eng = make_engine(ctx.pool[k], eps, device=ctx.device,
                          engine=ctx.traffic.get("engine", "grid"))
        ctx.state[(k, eps)] = eng
        if ctx.traffic.get("saved_counts", False):
            counts = dbscan(ctx.pool[k], eps, ctx.config["min_pts"],
                            eng=eng).counts
            ctx.state[("counts", k, eps)] = counts


def call(ctx, job, span) -> Output:
    from repro_torch.core.dbscan import dbscan

    pts = ctx.pool[job.dataset]
    saved = ctx.state.get(("counts", job.dataset, job.eps))
    with span("dbscan"):
        res = dbscan(pts, job.eps, job.min_pts,
                     eng=ctx.state[(job.dataset, job.eps)],
                     precomputed_counts=saved)
    with span("labels_to_host"):
        labels = res.labels.cpu()
    return Output(res.counts, res.core, labels, res.timings, None,
                  res.n_rounds)
