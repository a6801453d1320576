"""Models that the A/B tools (ab_parent.py, ab_draw_inline.py) time and
chip_smoke.py does not run, built through the model API from a
checkout's chip_smoke module ``c``, so that every checkout builds them
the same way."""


def two_class_chaos_4(c):
    """chip_smoke's two-class chaos arm at two front servers, which share
    the web tenant's 15/s (four servers in all: the lean instantiations'
    bound of 4): the batch edge loses 1% of its jobs, and the batch
    server times a job out after 0.5 s and retries it once."""
    model = c.EnsembleModel(horizon_s=c.HORIZON_S, warmup_s=c.WARMUP_S, macro_block=c.MACRO)
    web = model.source(rate=15.0)
    batch = model.source(rate=4.0, kind="constant")
    router = model.router(policy="least_outstanding")
    front = [model.server(service_mean=0.1, queue_capacity=256) for _ in range(2)]
    back = model.server(service_mean=0.125, queue_capacity=64, deadline_s=0.5, max_retries=1)
    spare = model.server(service_mean=0.125, queue_capacity=64)
    web_sink, batch_sink = model.sink(), model.sink()
    model.connect(web, router)
    for server in front:
        model.connect(router, server)
        model.connect(server, web_sink)
    model.connect(batch, back, latency_s=0.005, loss_p=0.01)
    model.connect(back, batch_sink)
    model.connect(spare, batch_sink)
    return model


def quorum_two_sources(c):
    """chip_smoke's defended quorum arm with a second source, Poisson at
    2/s, into its router: several sources with the consensus tier and the
    defenses (the whole MULTI chaos code)."""
    from happysim_tpu_torch.model import ROUTER, NodeRef

    model = c.quorum_model(True)
    model.connect(model.source(rate=2.0), NodeRef(ROUTER, 0))
    return model


# 32 cuts of 0.1 s, one every 0.35 s from 0.5 s (chip_smoke.FLAP_CUTS).
FLAP_CUTS = tuple((0.5 + 0.35 * k, 0.6 + 0.35 * k) for k in range(32))


def flapping_cuts(c):
    """chip_smoke's quorum_model undefended arm with its one cut of
    servers 1 and 2 replaced by FLAP_CUTS (chip_smoke.flapping_cuts_model,
    built here from quorum_model so that a checkout without it builds the
    same model)."""
    import dataclasses

    model = c.quorum_model(False)
    model.network_partitions[0] = dataclasses.replace(model.network_partitions[0], windows=FLAP_CUTS)
    return model
