"""``render.sphere_hit_share``: of the ray segments of the traced renders
(the ``render`` span's ``segments`` counts), the share whose closest hit is
a sphere (its ``sphere_hits`` counts), in %.  A path trapped inside a
sphere adds only sphere hits, so the share rises with such paths.  Nothing
where the program's ``render`` span counts no sphere hits (a scene without
spheres, or a tree from before it counted them)."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if run.traced is None or spans is None:
        return None
    roots = [s.attrs for s in spans if s.parent < 0 and s.name == "render"
             and "sphere_hits" in s.attrs and s.attrs.get("segments")]
    if not roots:
        return None
    return (100.0 * sum(a["sphere_hits"] for a in roots)
            / sum(a["segments"] for a in roots))
