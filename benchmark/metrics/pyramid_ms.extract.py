"""Wall milliseconds per ``build_pyramid`` call of the extraction steps in
the traced window, the span closed by a synchronize."""


def read(run):
    if run.kind != "extract" or not run.pyramid_s:
        return None
    return 1000.0 * sum(run.pyramid_s) / len(run.pyramid_s)
