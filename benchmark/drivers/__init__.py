"""Drivers, one a configuration's `driver` key names: each sets up the
system under test over the generator's tables, warms it, runs a window
of the mix's streams and hands back what the streams recorded."""
