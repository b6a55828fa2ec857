"""parse_string -> SceneBuilder.build (the host BVH builds, the tables'
upload), host clock, synchronized at both ends."""


def read(ctx):
    return ctx.setup.get("scene_build_s")
