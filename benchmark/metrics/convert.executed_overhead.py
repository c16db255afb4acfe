"""convert.executed_overhead: rows x frames the pass's dispatches run over its true frames, less 1 (%), from the Converter's own bucket plan (convert._bucket_stats)."""


def read(r):
    return 100.0 * r.cell.bucket_stats["executed_overhead"]
