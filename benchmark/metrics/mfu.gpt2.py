"""The GPT-2 step's share of the card's float32 peak (TF32 off): the
operations of the untraced stretch's tokens over their live context
(decode tokens and prefills, the configuration's Work) over its
seconds."""
from benchmark.common.readers import peak_share


def read(run):
    st = run.record.stretch
    if not st.get("seconds"):
        return None
    return peak_share(st["flops"] / st["seconds"], run, "f32")
