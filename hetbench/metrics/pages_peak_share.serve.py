"""Peak KV pages in use over the pool's pages (%): ServeReport.peak_pages
against pages_total (the worst-case pool the cell reserves),
serve/cache.py and serve/memory.py. Nothing to read without a pool."""


def read(run):
    if run.kind != "serve" or not run.report.pages_total:
        return None
    return 100.0 * run.report.peak_pages / run.report.pages_total
