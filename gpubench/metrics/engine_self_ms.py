"""Serving engine's self time: a wave's host-clock time inside
``ServeEngine.run`` outside ``Model.prefill`` (the harness's spans; in the
traced run the prefill span ends with a device sync, so it holds the
prefill's device work), in ms, averaged over the window's waves."""


def read(run):
    waves = run.spans.durations("engine.run")
    prefills = run.spans.durations("model.prefill")
    if not waves or len(waves) != len(prefills):
        return None
    return 1e3 * (sum(waves) - sum(prefills)) / len(waves)
