"""Host milliseconds a frame on the sensor's path: the mean latency of the
traced run's frames before its profiled stretch, less the stretch's
device milliseconds a frame (staging, the replay's launch, input copies
and output clones, the readback's wait, any wait for the source).  The
frames inside the stretch are not used: the profiler slows their host
path (by ~6 ms a frame at 640x480) and not their device work."""


def read(run):
    st = run.stretch
    lat = run.untraced_latencies_ms
    if st is None or not lat or run.traced_frames == 0 or st.busy_s <= 0:
        return None
    return sum(lat) / len(lat) - st.busy_s * 1e3 / run.traced_frames
