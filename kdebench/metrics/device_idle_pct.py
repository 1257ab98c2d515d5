"""The card's idle share over the traced stretch of whole chunks: 100 x
(1 - device busy / the stretch's length, synchronised at both ends)."""


def read(run):
    st = run.stretch
    if st is None or st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
