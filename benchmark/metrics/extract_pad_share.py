"""Share of padded rows among the level-0 rows handed to the extraction
step in the window: 100 (1 - valid rows / rows handed), over every step
the groups ran (a retried group counts each of its steps)."""


def read(run):
    handed = sum(run.step_rows)
    if run.kind != "extract" or not handed:
        return None
    return 100.0 * (1.0 - sum(run.step_valid) / handed)
