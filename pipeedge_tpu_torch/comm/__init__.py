"""Transport framing of the port: the wire-v2 frame (`wire`).

Port of the device half of `pipeedge_tpu/comm/`: the v2 frame a stage
output (or a KV ship bundle) travels in. The DCN transport, the v1 host
codec and the native codec wait for ROADMAP A6.
"""
