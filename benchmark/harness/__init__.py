"""The benchmark's general code: the manifest, the device, the traffic
generator, the program's set-up and spans, the trace reader, the run
loops and the check that decides ``correct``. Everything that belongs to
one configuration, traffic mix, per-layer metric or kernel count lives in
a file of its own that these modules find by name."""
