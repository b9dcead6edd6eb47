"""The WKV6 prefill kernel's share of its roofline over the traced
window: the sum of `roofline.wkv6_bound` (bf16 r, k, v, float32 w) over
each traced prefill's layers, over the sum of the device times of its
launches (``wkv6_kernel``), in %.  Nothing is read unless the trace holds
one launch a layer of each traced prefill."""
from bench import roofline, trace


def read(out):
    c = out.counters
    lens = c["traced_prefills"]
    if out.trace is None or not lens:
        return None
    m = c["model"]
    L, hd = m["n_layers"], m["wkv_head_dim"]
    H = m["d_model"] // hd
    launches = trace.kernel_launches(out.trace, ("wkv6_kernel",))
    if len(launches) != L * len(lens):
        return None
    need = sum(L * roofline.bound_ms(roofline.wkv6_bound(1, T, H, hd))
               for T in lens)
    return 100.0 * need / (sum(us for _, us in launches) * 1e-3)
