"""Tools of the port: `tools.probes` holds the probes of `tools/probes/`
that compile Pallas kernels, run on the card through `ops/gather_forms.py`."""
