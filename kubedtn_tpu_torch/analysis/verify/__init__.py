"""The runtime half of dtnverify's dispatch contract, for the port.

The JAX package's dtnverify traces the compiled tick programs into
jaxprs and checks them; the port's counterpart (an op recorder on
``TorchDispatchMode``) is not written yet. What is here runs on the
card: the canonical probe plane (``entrypoints``) and the dispatch
probe (``dispatch``), which counts the hand-written-kernel calls and
launches, the CUDA kernels and the host syncs of a steady tick, and
holds every sync site against the static sync pass's waivers.
"""
