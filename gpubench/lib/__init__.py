"""The harness's own pieces: the cell runner, spans, the trace reader,
the table of peaks and the frozen arithmetic of operations and bytes."""
