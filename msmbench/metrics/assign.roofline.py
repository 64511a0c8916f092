"""``assign.roofline``: the least time the assignment's work can take on
the card (``msmbench/roofline/assign.roofline.py``, from the unpadded
shapes) over the device time of the all-pairs kernel
(``qcp_matrix_kernel``, kernel 5) inside the ``assign_device`` span,
per job, in percent."""

from msmbench.harness import spec


def read(trace):
    spans = trace.span_list('assign')
    kern = [e for e in trace.inside(trace.gpu, 'assign')
            if 'qcp_matrix_kernel' in e.name]
    if not spans or not kern:
        return None
    device_s = 1e-6 * sum(e.end - e.start for e in kern) / len(spans)
    cfg = trace.config
    least = spec.roofline('assign.roofline').least_seconds(
        cfg['n_frames'], cfg['cluster']['n_clusters'], cfg['n_atoms'])
    return 100.0 * least / device_s
