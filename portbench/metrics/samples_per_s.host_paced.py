"""``samples_per_s`` in the host-paced cells (``pluto_batch_b256``,
``pluto_stream_c1_host``), whose host path sets the pace and whose runs
spread more between processes: the same reading, under its own bound or
its own end-to-end metric."""

from portbench import peaks

read = peaks.reader("samples_per_s")
