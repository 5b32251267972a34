from .pbr import (
    fresnel_schlick,
    ndf_ggx,
    lambda_ggx,
    masking_smith,
    lambert,
    frostbite_diffuse,
    pbr_specular,
    pbr_bsdf,
    prepare_shading_normal,
)
